"""peak_device_gib: the most device memory the allocator held during a
call of the traced window (``max_memory_allocated`` after
``reset_peak_memory_stats``), in GiB."""


def read(trace):
    peaks = [c["peak_bytes"] for c in trace["calls"] if c["peak_bytes"] is not None]
    return max(peaks) / 2**30 if peaks else None
