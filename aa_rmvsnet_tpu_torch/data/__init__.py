"""Evaluation and DTU training datasets, host-side prefetching and batching
(copies of ``aa_rmvsnet_tpu/data``)."""
