"""Device kernels a request, as the profiler counts them; read only where
the profiler's count of each of the path's own kernels is the count of its
wrapper's launches."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["requests"] or not tr["kernels"]:
        return None
    for role, name in tr["roles"].items():
        seen = sum(1 for k, _ in tr["kernels"] if k == name)
        if seen != tr["launches"].get(role, 0):
            return None
    return len(tr["kernels"]) / tr["requests"]
