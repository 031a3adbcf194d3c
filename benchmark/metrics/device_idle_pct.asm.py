"""The share of one assembly's wall in which the device ran nothing:
1 - (the union of its kernel, copy and set intervals in a CUDA-only
torch.profiler trace) / the assembly's wall, in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
