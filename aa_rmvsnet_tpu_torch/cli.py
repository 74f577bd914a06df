"""Command-line entry point: ``python -m aa_rmvsnet_tpu_torch.cli eval``.

The port has one subcommand so far, ``eval``: depth and confidence maps
for a scene list, from a reference torch ``.ckpt``, on the card by default
(``--device cpu`` to run on the CPU).  It always runs fp32: bf16, the JAX
CLI's default, is not ported, so ``--fp32`` is not needed and not taken.
Flags of the JAX CLI's ``eval`` that the port does not implement yet are
accepted by the parser only to fail with "not ported yet"; the JAX CLI's
other subcommands are not ported.
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
    for name in NOT_PORTED:
        p.add_argument(f"--{name}", nargs="?", const=True, default=None,
                       help="not ported yet")
    return p


def cmd_eval(args):
    asked = [f"--{n}" for n in NOT_PORTED if getattr(args, n) is not None]
    if asked:
        raise SystemExit(f"{', '.join(asked)}: not ported yet to aa_rmvsnet_tpu_torch")

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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aa_rmvsnet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_eval(sub)
    args = parser.parse_args(argv)
    {"eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
