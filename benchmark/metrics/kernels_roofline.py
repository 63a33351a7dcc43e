"""kernels_roofline: the port's kernels (``csrc/*.cu`` through ``ops/*``)
over their roofline in the profiled call that records them: the sum of each launch's bound
(``kernels/<kernel>.py`` through ``harness/work.py``: the larger of its
bytes over the memory rate and its integer operations over the integer
rate, from the launch's own inputs) over the sum of the launches' device
times (``torch.profiler``), in %.  Nothing is read where no port kernel
ran on a card (a run on the CPU)."""


def read(trace):
    launches = trace["kernel_profile"]["launches"]
    ms = sum(x[1] for x in launches)
    if ms <= 0:
        return None
    return 100.0 * sum(x[2] for x in launches) / ms
