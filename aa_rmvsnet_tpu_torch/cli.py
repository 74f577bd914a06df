"""Command-line entry point: ``python -m aa_rmvsnet_tpu_torch.cli
{eval,train}``.

- ``eval``: depth and confidence maps for a scene list, from a reference
  torch ``.ckpt`` (or one that ``train`` wrote); with ``--evidential_ckpt``
  also the evidential head's aleatoric and epistemic maps.
- ``train``: the core network on DTU (``data/dtu.py``), from scratch or
  from ``--loadckpt``, with checkpoints in ``--logdir`` and ``--resume``;
  with ``--evidential`` the evidential head with it (``loss_emvsnet``),
  fresh or from ``--head_ckpt``.

Both run on the card by default (``--device cpu`` to run on the CPU).
``eval`` runs, as the JAX CLI does by default, in bf16 with the packed-row
warp wherever its exactness gate passes and the fused squared residual;
``--fp32 --packed_rows 0`` is the exact fp32 path.  The JAX CLI's
quantized levers (``--fp8_tables``, ``--int8_tables``, ``--fp8_residual``,
``--int8_residual``, ``--dual_residual``) are approximate and opt-in; the
JAX package's production stack is ``--int8_tables --dual_residual
--gather_pack 2 --table_taps 6``.  ``train`` runs in fp32.  Flags of the
JAX CLI that the port does not implement yet are
accepted by the parser only to fail with "not ported yet"; the JAX CLI's
other subcommands are not ported.
"""

from __future__ import annotations

import argparse

#: JAX ``eval`` flags the port does not implement yet (FeatNet view
#: chunks, multi-device layouts, previews, dataset checks).
NOT_PORTED = (
    "feat_chunk", "fanout", "spatial", "depth_stages", "pipeline_maps", "save_png",
    "dry_check",
)


#: JAX ``train`` flags the port does not implement yet (multi-process and
#: multi-device layouts).
NOT_PORTED_TRAIN = (
    "coordinator", "num_processes", "process_id", "spatial", "single_device",
)


def _fold_omega_arg(s: str):
    """Strict parser for --fold_omega: {0, 1, hybrid} only, so that a typo
    fails loudly instead of selecting another path."""
    table = {"0": False, "1": True, "hybrid": "hybrid"}
    if s not in table:
        raise argparse.ArgumentTypeError(
            f"--fold_omega must be 0, 1 or 'hybrid' (got {s!r})")
    return table[s]


def _packed_rows_arg(s: str):
    table = {"0": False, "1": True, "auto": "auto"}
    if s not in table:
        raise argparse.ArgumentTypeError(
            f"--packed_rows must be 0, 1 or 'auto' (got {s!r})")
    return table[s]


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
    p.add_argument("--fp32", action="store_true",
                   help="fp32 features and sweep (default bf16)")
    p.add_argument("--fold_omega", nargs="?", const=True, default=False,
                   type=_fold_omega_arg,
                   help="bare flag or '1': depth-folded cost layout; 'hybrid': "
                        "the 2x2 gather with omega folded (same costs)")
    p.add_argument("--packed_rows", default="auto", type=_packed_rows_arg,
                   help="one 4x4 warp row per (view, pixel) serving the whole "
                        "depth block; 'auto' (default) where the 2 px exactness "
                        "gate passes, 1/0 force on/off")
    p.add_argument("--gather_pack", type=int, default=1,
                   help="one packed row serves gather_pack*depth_block "
                        "hypotheses (gated per sample)")
    p.add_argument("--table_taps", type=int, default=4, choices=[4, 6],
                   help="packed window per axis: 6 stores 2.25x the table for "
                        "a 4 px exactness span")
    p.add_argument("--no_fused_residual", action="store_true",
                   help="materialise the warped volume on packed samples "
                        "(same result as the fused squared residual)")
    p.add_argument("--fp8_residual", action="store_true",
                   help="store the squared residual in fp8 (APPROXIMATE; "
                        "see the guardrails in tests/test_torch_quant_pipeline.py)")
    p.add_argument("--dual_residual", action="store_true",
                   help="store the squared residual TWICE: an fp8 copy "
                        "for the variance (its precision profile) + an "
                        "int8 copy consumed by omega's int8 conv, the "
                        "quality-safe int8-residual variant")
    p.add_argument("--int8_residual", action="store_true",
                   help="store the squared residual in int8 and feed "
                        "omega's rw0 conv the quantized tensor directly "
                        "(LOSSIER than fp8 on the small-residual end)")
    p.add_argument("--fp8_tables", action="store_true",
                   help="fp8-quantized warp patch tables (a quarter of fp32's "
                        "and half of bf16's bytes on the gather)")
    p.add_argument("--int8_tables", action="store_true",
                   help="int8-quantized warp patch tables + the int8 blend "
                        "on packed samples (same bytes as fp8, more accurate "
                        "than fp8 in the JAX package's tests)")
    p.add_argument("--evidential_ckpt",
                   help="evidential head weights (torch .ckpt, evidential.* keys or the "
                        "head's own); writes aleatoric_0/epistemic_0 maps")
    p.add_argument("--depth_source", choices=["wta", "evidential"],
                   help="depth map source; defaults to 'evidential' when "
                        "--evidential_ckpt is given, else the core WTA depth")
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
    p.add_argument("--evidential", action="store_true",
                   help="attach the evidential head and train with loss_emvsnet")
    p.add_argument("--head_ckpt",
                   help="warm-start head weights (torch .ckpt; needs --evidential)")
    p.add_argument("--maxdisp", type=int,
                   help="the head's depth hypotheses (default 32; needs --evidential)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    _add_not_ported(p, NOT_PORTED_TRAIN)
    return p


def cmd_eval(args):
    _refuse_not_ported(args, NOT_PORTED)

    import torch

    from .data.eval_dataset import EvalDataset
    from .models.convert import load_evidential_checkpoint, load_reference_checkpoint
    from .models.evidential import EvidentialHead
    from .models.network import AARMVSNetCore
    from .pipeline.infer import InferConfig, run_inference
    from .utils.config import eval_preset

    head = None
    if args.evidential_ckpt:
        try:
            head = load_evidential_checkpoint(EvidentialHead(), args.evidential_ckpt)
        except NotImplementedError as exc:
            raise SystemExit(f"--evidential_ckpt {exc}") from exc
    depth_source = args.depth_source or ("evidential" if head is not None else "wta")
    if depth_source == "evidential" and head is None:
        raise SystemExit("--depth_source evidential requires --evidential_ckpt")

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
        InferConfig(
            out_root=args.outdir, depth_block=cfg.depth_block,
            # As in the JAX CLI, the precision comes from --fp32 alone; the
            # preset's use_bfloat16 is not read.
            feature_dtype=torch.float32 if args.fp32 else torch.bfloat16,
            fold_omega=args.fold_omega, packed_rows=args.packed_rows,
            gather_pack=args.gather_pack, table_taps=args.table_taps,
            fused_residual=not args.no_fused_residual, device=args.device,
            evidential=head, depth_source=depth_source,
            # The JAX CLI's precedence: int8 tables over fp8; a dual
            # residual over int8, int8 over fp8.
            table_dtype=(torch.int8 if args.int8_tables
                         else torch.float8_e4m3fn if args.fp8_tables else None),
            residual_dtype=("dual" if args.dual_residual
                            else torch.int8 if args.int8_residual
                            else torch.float8_e4m3fn if args.fp8_residual else None),
        ),
    )
    print(f"eval done: {stats['count']} maps, {stats['maps_per_s']:.3f} maps/s")


def cmd_train(args):
    _refuse_not_ported(args, NOT_PORTED_TRAIN)
    if not args.evidential:
        given = [f"--{n}" for n in ("head_ckpt", "maxdisp") if getattr(args, n) is not None]
        if given:
            raise SystemExit(f"{', '.join(given)} needs --evidential")

    import torch

    from .data.dtu import DTUTrainDataset
    from .models.convert import load_evidential_checkpoint, load_reference_checkpoint
    from .models.evidential import EvidentialHead
    from .models.network import AARMVSNetCore
    from .pipeline.train import TrainConfig, run_training
    from .utils.config import train_preset

    head = None
    maxdisp = 32 if args.maxdisp is None else args.maxdisp
    if args.evidential:
        # A fresh head from seed 1, as the JAX CLI's PRNGKey(1).
        head = EvidentialHead(maxdisp, generator=torch.Generator().manual_seed(1))
        if args.head_ckpt:
            try:
                load_evidential_checkpoint(head, args.head_ckpt)
            except NotImplementedError as exc:
                raise SystemExit(f"--head_ckpt {exc}") from exc

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
        evidential=args.evidential, maxdisp=maxdisp,
    )
    try:
        stats = run_training(model, ds, config, val_dataset=val_ds, logger=logger, head=head)
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
