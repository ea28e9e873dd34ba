"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the measured package."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "blitzdg_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "blitzdg_tpu_torch" not in tops and "portbench" not in tops


def test_the_scan_sees_the_port_as_its_own_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import blitzdg_tpu_torch.ops\nfrom blitzdg_tpu import x\n")
    assert imported_tops(probe) == {"blitzdg_tpu_torch", "blitzdg_tpu"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmark(path):
    script, records = "bench" + ".py", "BENCH" + "_"
    text = path.read_text().replace("port" + script, "")
    assert script not in text and records not in text
