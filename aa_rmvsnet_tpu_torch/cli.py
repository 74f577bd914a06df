"""Command-line entry point: ``python -m aa_rmvsnet_tpu_torch.cli
{eval,train}``.

- ``eval``: depth and confidence maps for a scene list, from a reference
  torch ``.ckpt`` (or one that ``train`` wrote).
- ``train``: the core network on DTU (``data/dtu.py``), from scratch or
  from ``--loadckpt``, with checkpoints in ``--logdir`` and ``--resume``.

Both run on the card by default (``--device cpu`` to run on the CPU), in
fp32: bf16, the JAX CLI's default, is not ported, so ``--fp32`` is not
needed and not taken.  Flags of the JAX CLI that the port does not
implement yet are accepted by the parser only to fail with "not ported
yet"; the JAX CLI's other subcommands are not ported.
"""

from __future__ import annotations

import argparse

#: JAX ``eval`` flags the port does not implement yet (packed, folded and
#: quantized warp levers, multi-device layouts, the evidential head,
#: previews, dataset checks).
NOT_PORTED = (
    "fold_omega", "packed_rows", "gather_pack", "table_taps", "feat_chunk",
    "fp8_residual", "dual_residual", "int8_residual", "no_fused_residual",
    "fp8_tables", "int8_tables", "fanout", "spatial", "depth_stages",
    "pipeline_maps", "evidential_ckpt", "depth_source", "save_png", "dry_check",
)


#: JAX ``train`` flags the port does not implement yet (the evidential
#: head, multi-process and multi-device layouts).
NOT_PORTED_TRAIN = (
    "evidential", "head_ckpt", "maxdisp", "coordinator", "num_processes",
    "process_id", "spatial", "single_device",
)


def _add_not_ported(p, names):
    for name in names:
        p.add_argument(f"--{name}", nargs="?", const=True, default=None,
                       help="not ported yet")


def _refuse_not_ported(args, names):
    asked = [f"--{n}" for n in names if getattr(args, n) is not None]
    if asked:
        raise SystemExit(f"{', '.join(asked)}: not ported yet to aa_rmvsnet_tpu_torch")


def _add_eval(sub):
    p = sub.add_parser("eval", help="generate depth maps")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True, help="file with one scan per line")
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--preset", default="dtu_eval")
    p.add_argument("--loadckpt", required=True, help="reference torch .ckpt")
    p.add_argument("--view_num", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--max_h", type=int)
    p.add_argument("--max_w", type=int)
    p.add_argument("--depth_block", type=int, help="hypotheses per sweep block")
    p.add_argument("--interval_scale", type=float,
                   help="depth interval scale (reference eval.py default 1.0)")
    p.add_argument("--inverse_depth", action="store_true",
                   help="open-ended inverse-depth sweep from each cam's depth_min")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    _add_not_ported(p, NOT_PORTED)
    return p


def _add_train(sub):
    p = sub.add_parser("train", help="train the core network on DTU")
    p.add_argument("--trainpath", required=True)
    p.add_argument("--trainlist", required=True)
    p.add_argument("--vallist")
    p.add_argument("--logdir", default="checkpoints_torch")
    p.add_argument("--preset", default="dtu_train",
                   help="defaults of the flags below (utils/config.py)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--view_num", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--interval_scale", type=float)
    p.add_argument("--image_scale", type=float)
    p.add_argument("--lr", type=float)
    p.add_argument("--depth_block", type=int, help="hypotheses per remat block")
    p.add_argument("--seed", type=int, help="data order")
    p.add_argument("--loadckpt", help="reference torch .ckpt to start from")
    p.add_argument("--resume", action="store_true",
                   help="continue from the highest checkpoint in --logdir")
    p.add_argument("--max_steps", type=int, help="stop early (after a checkpoint)")
    p.add_argument("--summary_freq", type=int)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_tensorboard", action="store_true",
                   help="log to stdout only (no tensorboardX)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    _add_not_ported(p, NOT_PORTED_TRAIN)
    return p


def cmd_eval(args):
    _refuse_not_ported(args, NOT_PORTED)

    from .data.eval_dataset import EvalDataset
    from .models.convert import load_reference_checkpoint
    from .models.network import AARMVSNetCore
    from .pipeline.infer import InferConfig, run_inference
    from .utils.config import eval_preset

    overrides = {
        k: v
        for k, v in (
            ("nviews", args.view_num), ("ndepths", args.numdepth),
            ("max_h", args.max_h), ("max_w", args.max_w),
            ("depth_block", args.depth_block),
            ("interval_scale", args.interval_scale),
            ("inverse_depth", True if args.inverse_depth else None),
        )
        if v is not None
    }
    cfg = eval_preset(args.preset, **overrides)
    ds = EvalDataset(
        args.testpath, args.testlist, nviews=cfg.nviews, ndepths=cfg.ndepths,
        interval_scale=cfg.interval_scale, inverse_depth=cfg.inverse_depth,
        max_h=cfg.max_h, max_w=cfg.max_w, pad_vertical=cfg.pad_vertical,
    )
    model = load_reference_checkpoint(AARMVSNetCore(), args.loadckpt)
    stats = run_inference(
        model, ds,
        InferConfig(out_root=args.outdir, depth_block=cfg.depth_block,
                    device=args.device),
    )
    print(f"eval done: {stats['count']} maps, {stats['maps_per_s']:.3f} maps/s")


def cmd_train(args):
    _refuse_not_ported(args, NOT_PORTED_TRAIN)

    from .data.dtu import DTUTrainDataset
    from .models.convert import load_reference_checkpoint
    from .models.network import AARMVSNetCore
    from .pipeline.train import TrainConfig, run_training
    from .utils.config import train_preset

    overrides = {
        k: v
        for k, v in (
            ("epochs", args.epochs), ("batch_size", args.batch_size),
            ("nviews", args.view_num), ("ndepths", args.numdepth),
            ("interval_scale", args.interval_scale),
            ("image_scale", args.image_scale), ("learning_rate", args.lr),
            ("depth_block", args.depth_block), ("seed", args.seed),
            ("summary_freq", args.summary_freq),
        )
        if v is not None
    }
    cfg = train_preset(args.preset, datapath=args.trainpath, train_list=args.trainlist,
                       val_list=args.vallist or "", logdir=args.logdir,
                       loadckpt=args.loadckpt, resume=args.resume, **overrides)
    ds = DTUTrainDataset(cfg.datapath, cfg.train_list, nviews=cfg.nviews,
                         ndepths=cfg.ndepths, interval_scale=cfg.interval_scale,
                         image_scale=cfg.image_scale)
    val_ds = None
    if cfg.val_list:
        val_ds = DTUTrainDataset(cfg.datapath, cfg.val_list, nviews=cfg.nviews,
                                 ndepths=cfg.ndepths, interval_scale=cfg.interval_scale,
                                 image_scale=cfg.image_scale, light_idx=3, both=False)
    model = AARMVSNetCore()
    if cfg.loadckpt:
        load_reference_checkpoint(model, cfg.loadckpt)
    logger = None
    if not args.no_tensorboard:
        from .utils.logging import TrainLogger

        logger = TrainLogger(cfg.logdir)
    config = TrainConfig(
        learning_rate=cfg.learning_rate, lr_min=cfg.lr_min, depth_block=cfg.depth_block,
        epochs=cfg.epochs, batch_size=cfg.batch_size, num_workers=args.num_workers,
        summary_freq=cfg.summary_freq, max_steps=args.max_steps, logdir=cfg.logdir,
        resume=cfg.resume, seed=cfg.seed, device=args.device,
    )
    try:
        stats = run_training(model, ds, config, val_dataset=val_ds, logger=logger)
    finally:
        if logger is not None:
            logger.close()
    print(f"train done: steps {stats['start_step']} -> {stats['step']}, "
          f"checkpoints in {cfg.logdir}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aa_rmvsnet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_eval(sub)
    _add_train(sub)
    args = parser.parse_args(argv)
    {"eval": cmd_eval, "train": cmd_train}[args.cmd](args)


if __name__ == "__main__":
    main()
