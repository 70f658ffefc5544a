"""Data, FSDP, tensor, sequence and pipeline parallelism over
``torch.distributed`` (counterpart of ``sndepth_tpu/parallel``)."""
