"""The benchmark of the port (``buddy_tpu_torch``) on NVIDIA H100s: run
``python3 -m portbench.run``; see ``portbench/README.md``."""
