"""Serving artifacts (counterpart of ``sndepth_tpu/serving``)."""
