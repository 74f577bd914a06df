"""Evaluation and DTU training datasets, host-side prefetching and batching
(copies of ``aa_rmvsnet_tpu/data``), and the dataset check of ``cli eval
--dry_check`` (``validate``)."""


def find_dataset_def(name: str):
    """The dataset class (or partial) of ``name``, with the reference's
    module names as aliases (reference datasets/__init__.py:5-8; the JAX
    package's registry)."""
    import functools

    from .dtu import DTUTrainDataset
    from .eval_dataset import EvalDataset

    registry = {
        "dtu": DTUTrainDataset,
        "dtu_yao": DTUTrainDataset,
        "eval": EvalDataset,
        "data_eval_transform": EvalDataset,
        "data_eval_transform_padding": functools.partial(EvalDataset, pad_vertical=True),
    }
    if name not in registry:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(registry)}")
    return registry[name]
