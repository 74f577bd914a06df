"""Evaluation dataset and host-side prefetching (copies of
``aa_rmvsnet_tpu/data``)."""
