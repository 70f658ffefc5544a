"""The benchmark of the PyTorch and CUDA port (``sndepth_tpu_torch``) on
NVIDIA H100 cards. ``python -m gpubench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; see README.md."""
