"""ROADMAP C31: the coastal K=2048, N=3 set of ``chip_smoke.py``'s peer path
(``peer_problem``: bathymetry with the well-balanced star fluxes, drag,
Coriolis, tidal depth on the open east side, sponge toward it, two
injectors) stops being finite after some 450 steps at its dt, and the JAX
package's plain step does the same on the same inputs: the blow-up is the
reference's, not a fault of the port.

The port: its plain sharded step (``make_sharded_blocked_step_fused`` on CPU
tensors) at S=1, B=1, in float64, from ``chip_smoke.py``'s perturbed state
(``perturbed_blocked``, seed 0) with controls 0.3 N(0, 1), 64 rows cycled,
from t0 = 1. The reference: SSP-RK2 over ``blitzdg_tpu/ops/sw2d.py``'s
``sw2d_rhs`` with the tidal forcing and the injected controls, the modal
filter after each RHS and ``sponge_relax`` after each step, unsharded, on
the same mesh (the partitioned one's arrays), state and controls, in
float64. The two agree to 1e-9 through step 400 and stop being finite at
the same step (within one), so a run of this set is held to the reference
only over a shorter time (``chip_smoke.py``'s ``PEER_LONG_DT_FRACTION``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as C
from blitzdg_tpu.mesh.gmsh import build_mesh as jax_build_mesh
from blitzdg_tpu.ops.sw2d import SWPhysics as JaxPhysics
from blitzdg_tpu.ops.sw2d import SWState, apply_filter, sponge_relax, sw2d_rhs
from blitzdg_tpu.specgrid.triangle import build_triangle_context as jax_ctx
from blitzdg_tpu.timestepping import ssprk2_step
from blitzdg_tpu_torch.context import BC_OUT
from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc import sharded_box as sbx
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel import partition_mesh
from blitzdg_tpu_torch.utils import build_sponge_coefficient

F64 = torch.float64
MAX_STEPS = 460  # past the blow-up
AGREE_STEPS = 400  # the two held to 1e-9 through this step
TIDAL = (12.0, 0.5, 2.0, 10.0)  # peer_problem's


def _first_nonfinite(step, state, n_steps):
    """Runs ``step(state, k) -> (state, fields)`` until a field is not
    finite: (the first such step or None, the fields of each step)."""
    out = []
    for k in range(n_steps):
        state, fields = step(state, k)
        if not np.isfinite(fields).all():
            return k, out
        out.append(fields)
    return None, out


def test_coastal_set_blows_up_where_the_reference_does():
    cc, sb, H, dt = C.peer_problem(1, "cpu", dtype=F64)
    rng = np.random.default_rng(0)
    xy = types.SimpleNamespace(x=cc.x.float(), y=cc.y.float())
    h, hu, hv, _ = C.perturbed_blocked(xy, H.float().reshape(1, -1), 1, 1, 2,
                                       rng, "cpu")
    cs = 0.3 * rng.standard_normal((64, 2))
    K, n_p = cc.k_elem, cc.n_p

    # the port
    pstep = BS.make_sharded_blocked_step_fused(sb, dt)
    state = tuple(BS.split_shards(f.to(F64), 1) for f in (h, hu, hv))

    def port(carry, k):
        carry = pstep(carry, 1.0 + k * dt, torch.as_tensor(cs[k % 64],
                                                           dtype=F64))
        return carry, np.stack([f.reshape(-1).numpy() for f in carry[0]])

    port_bad, port_fields = _first_nonfinite(
        port, (state, BS.initial_send_buffer(sb, state)), MAX_STEPS)

    # the reference, on the same mesh and physics (peer_problem's)
    m = box_triangles(*sbx.CELLS)
    retag_east_open(m)
    m = partition_mesh(m, 1)[0]
    jm = jax_build_mesh(np.asarray(m.verts), np.asarray(m.etov))
    jm.set_bc_type(np.asarray(m.bc_type))
    n = sbx.N_ORDER
    jc = jax_ctx(n, jm, filter_cutoff=0.9 * n, filter_order=4)
    assert float(np.abs(np.asarray(jc.x) - cc.x.numpy()).max()) == 0.0
    x, y = cc.x.numpy(), cc.y.numpy()
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(K, -1) == BC_OUT).numpy()
    sponge = build_sponge_coefficient(cc, open_nodes, width=0.3,
                                      strength=0.5)
    phys = JaxPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4,
                      H=jnp.asarray(10.0 + 2.0 * x + np.sin(2.0 * y)),
                      Hx=jnp.asarray(2.0 * np.ones_like(x)),
                      Hy=jnp.asarray(2.0 * np.cos(2.0 * y)),
                      sponge=jnp.asarray(np.asarray(sponge)))
    h0, amp, omega, tau = TIDAL
    tide = lambda t: h0 + amp * jnp.cos(omega * t) * jnp.minimum(t / tau, 1.0)
    bu, bv = (jnp.asarray(a) for a in sbx.injectors(cc))

    @jax.jit
    def jstep(s, t, c):
        def rhs(v, tt):
            r = sw2d_rhs(jc, v, tt, phys, tidal_forcing=tide)
            return SWState(h=r.h, hu=r.hu + c[0] * bu[0] + c[1] * bu[1],
                           hv=r.hv + c[0] * bv[0] + c[1] * bv[1])

        out = ssprk2_step(rhs, s, t, dt, post_stage=lambda f: apply_filter(
            jc, f))
        return sponge_relax(out, phys, dt)

    def ref(s, k):
        s = jstep(s, 1.0 + k * dt, jnp.asarray(cs[k % 64]))
        return s, np.stack([np.asarray(f).reshape(-1) for f in s])

    js = SWState(*(jnp.asarray(f.double().numpy().reshape(K, n_p))
                   for f in (h, hu, hv)))
    ref_bad, ref_fields = _first_nonfinite(ref, js, MAX_STEPS)

    # the reference blows up, and the port with it, within one step
    assert ref_bad is not None and port_bad is not None
    assert abs(port_bad - ref_bad) <= 1
    assert ref_bad > AGREE_STEPS
    for k in range(AGREE_STEPS):
        assert float(np.abs(port_fields[k] - ref_fields[k]).max()) <= 1e-9, k
