"""muscato_tpu_torch — the matching engine of ``muscato_tpu`` on PyTorch and
hand-written CUDA kernels for one NVIDIA Hopper GPU.

The package mirrors ``muscato_tpu``'s layout (``ops/``, ``engine/``,
``cli.py``) so that each module's counterpart is easy to find, and it gives
the same ``MatchResult`` and report bytes.  It keeps its own copies of the
JAX package's framework-free host layer (``io/``, ``config.py``,
``bench/gendat.py``, which differ from the originals only in their imports)
and imports neither ``jax`` nor any module of ``muscato_tpu``.

Device code is plain PyTorch on tensors that live on an explicit
``device``; the kernels of the matching path (``ops/join.py``,
``ops/expand.py``, ``ops/gather.py``, ``ops/window_queries.py``) are CUDA
C++ in ``csrc/``, built with ``nvcc`` on first use.  On CPU tensors each kernel wrapper runs its plain
PyTorch twin, which is how the tests run without a GPU.
"""

__version__ = "0.1.0"
