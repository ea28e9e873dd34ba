"""Device ms a request of every kernel that is none of the path's step or
rollout kernels: the optimizer's update, the cost, autograd's glue."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["requests"] or not tr["kernels"]:
        return None
    own = set(tr["roles"].values())
    rest = sum(s for k, s in tr["kernels"] if k not in own)
    return 1e3 * rest / tr["requests"]
