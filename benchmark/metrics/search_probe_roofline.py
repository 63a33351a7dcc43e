"""search_probe_roofline: the search probe's kernels, B8
(``direct_probe``) and B9 (``binary_probe``), over their roofline in the
profiled call that records them: the sum of their launches' bounds
(``kernels/direct_probe.py`` and ``kernels/binary_probe.py`` through
``harness/work.py``) over the sum of their device times
(``torch.profiler``), in %.  None where neither launched on a card."""

KERNELS = ("direct_probe", "binary_probe")


def read(trace):
    launches = [x for x in trace["kernel_profile"]["launches"] if x[0] in KERNELS]
    ms = sum(x[1] for x in launches)
    if ms <= 0:
        return None
    return 100.0 * sum(x[2] for x in launches) / ms
