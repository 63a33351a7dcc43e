"""Reference-scale job scripts of the port: the parallel disk-streamed
data generator (``gen_parallel``) and the 100M-read driver run
(``run_100m``), each run as ``python -m muscato_tpu_torch.scripts.<name>``."""
