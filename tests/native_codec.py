"""One native host library for both packages, for the tests that compare
.sz bytes across them.  The library (native/libmuscato_native.so) is a
build that may be absent when a run starts: the bench runners'
``ensure_built()`` then builds it, maybe on another worker in the middle
of the run.  A module that probed before it appeared keeps the
pure-Python snappy codec, whose frames differ from the native codec's
(both decode to the same text), so two packages that probe at different
moments write different bytes."""

import os

import pytest

from muscato_tpu.io import native as jnative
from muscato_tpu_torch.io import native as tnative


@pytest.fixture
def same_codec(monkeypatch):
    """Both packages' modules hold the one handle (or None) that the port's
    module loads now, so both compress with the same codec in this
    process; their caches are restored after the test."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(jnative, "_LIB", tnative.get_lib())
    monkeypatch.setattr(jnative, "_TRIED", True)


def _so_state():
    try:
        st = os.stat(tnative._SO)
    except FileNotFoundError:
        return None
    return st.st_size, st.st_mtime_ns


def run_settled(run, turns=3):
    """Call ``run``, whose child processes each probe the library, until
    the library file did not change while it ran, so every child saw the
    same file.  The file appears once in a run: a second turn, or a third
    when the first saw it half written, settles it."""
    for _ in range(turns):
        before = _so_state()
        run()
        if _so_state() == before:
            return
    raise AssertionError(f"{tnative._SO} kept changing over {turns} turns")
