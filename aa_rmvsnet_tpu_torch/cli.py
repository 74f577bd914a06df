"""Command-line entry point: ``python -m aa_rmvsnet_tpu_torch.cli
{eval,fuse,train,convert,analyze,quality,viz}``.

- ``eval``: depth and confidence maps for a scene list, from a reference
  torch ``.ckpt``, one that ``train`` or ``convert`` wrote, or an orbax
  directory of the JAX package; with ``--evidential_ckpt`` also the
  evidential head's aleatoric and epistemic maps; ``--save_png`` adds
  colour-mapped PNG previews; ``--dry_check`` checks the dataset root's
  layout and exits without running the model.
- ``fuse``: the consistency filter and point-cloud fusion of ``eval``'s
  maps into one PLY per scan (``dtu``, ``tnt`` or ``tnt_padded``), by
  scan shard (``--host_id/--num_hosts``) or by reference-view block
  (``--view_block``, then ``--merge_blocks``).
- ``train``: the core network on DTU (``data/dtu.py``), from scratch or
  from ``--loadckpt``, with checkpoints in ``--logdir`` and ``--resume``;
  with ``--evidential`` the evidential head with it (``loss_emvsnet``),
  fresh or from ``--head_ckpt``.
- ``convert``: an orbax checkpoint of the JAX package (a params
  directory, a ``cli train`` step or logdir) to a torch ``.ckpt`` under the
  reference key names, the way back from JAX's ``convert``; it reads orbax
  with tensorstore, on a host that has it.
- ``analyze``: the uncertainty analytics over a training logdir's
  ``.npz`` dumps (numpy, scikit-learn, scipy and matplotlib, on the host).
- ``quality``: accuracy and completeness of a fused PLY against a
  ground-truth cloud (numpy and scipy, on the host).
- ``viz``: the module tree with parameter counts and a graphviz DOT graph
  of the flax parameter tree.

``eval``, ``fuse`` and ``train`` run on the card by default (``--device
cpu`` to run on the CPU).
``eval`` runs, as the JAX CLI does by default, in bf16 with the packed-row
warp wherever its exactness gate passes and the fused squared residual;
``--fp32 --packed_rows 0`` is the exact fp32 path.  The JAX CLI's
quantized levers (``--fp8_tables``, ``--int8_tables``, ``--fp8_residual``,
``--int8_residual``, ``--dual_residual``) are approximate and opt-in; the
JAX package's production stack is ``--int8_tables --dual_residual
--gather_pack 2 --table_taps 6``.  ``train`` runs in fp32; with
``--coordinator host:port --num_processes N --process_id k`` it trains data
parallel across N processes on ``torch.distributed`` (one card each, NCCL;
gloo with ``--device cpu``), ``--batch_size`` per process, as the JAX CLI
does, and ``--single_device`` makes each process step alone on its shard;
``--spatial S`` splits each batch's rows over S of the N processes (the
data axis is N / S, the global batch still ``--batch_size`` x N; with
``--evidential`` each of the S ranks runs the head on its rows of the cost
volume, so the map's height over S must be a multiple of 4).
``eval --fanout N`` (the samples spread over N ranks), ``eval --spatial S``
(each map's rows split over S ranks, with ``--fanout`` too; with
``--evidential_ckpt`` each rank runs the head on its rows and only its
four maps are gathered) and ``eval
--depth_stages P [--pipeline_maps M]`` (the depth-block pipeline over P
ranks) start their ranks themselves, on a free port of localhost: rank
``k`` on ``cuda:{k % device_count}``, NCCL where every rank has a card of
its own and gloo otherwise (so that ranks can share one card), gloo ranks
on the CPU with ``--device cpu``; a rank that fails fails the command.
"""

from __future__ import annotations

import argparse


def _fold_omega_arg(s: str):
    """Strict parser for --fold_omega: {0, 1, hybrid} only, so that a typo
    fails loudly instead of selecting another path."""
    table = {"0": False, "1": True, "hybrid": "hybrid"}
    if s not in table:
        raise argparse.ArgumentTypeError(
            f"--fold_omega must be 0, 1 or 'hybrid' (got {s!r})")
    return table[s]


def _depth_block_arg(s: str):
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--depth_block must be an integer or 'auto' (got {s!r})") from None


def _packed_rows_arg(s: str):
    table = {"0": False, "1": True, "auto": "auto"}
    if s not in table:
        raise argparse.ArgumentTypeError(
            f"--packed_rows must be 0, 1 or 'auto' (got {s!r})")
    return table[s]


def _add_eval(sub):
    p = sub.add_parser("eval", help="generate depth maps")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True, help="file with one scan per line")
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--preset", default="dtu_eval")
    p.add_argument("--loadckpt", help="torch .ckpt or orbax directory (required "
                                      "unless --dry_check)")
    p.add_argument("--dry_check", action="store_true",
                   help="check the dataset root's layout (pair.txt, cams, images, "
                        "cam-file shapes) and exit without running the model")
    p.add_argument("--view_num", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--max_h", type=int)
    p.add_argument("--max_w", type=int)
    p.add_argument("--depth_block", type=_depth_block_arg,
                   help="hypotheses per sweep block, or 'auto': the largest of "
                        "8, 4, 2, 1 whose memory estimate fits the card "
                        "(utils.config.derive_depth_block)")
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
    p.add_argument("--feat_chunk", type=int, default=0,
                   help="FeatNet view-chunk size (0 = all views at once); "
                        "bounds feature-extraction peak memory at big sizes")
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
                        "head's own, or orbax directory); writes aleatoric_0/"
                        "epistemic_0 maps")
    p.add_argument("--depth_source", choices=["wta", "evidential"],
                   help="depth map source; defaults to 'evidential' when "
                        "--evidential_ckpt is given, else the core WTA depth")
    p.add_argument("--save_png", action="store_true",
                   help="colour-mapped PNG previews beside every PFM family")
    p.add_argument("--pallas_gates", action="store_true",
                   help="accepted for the JAX CLI's command lines; no effect: the port "
                        "always runs its ConvLSTM gate kernel on the card")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    p.add_argument("--fanout", type=int, default=1,
                   help="spread the samples over N ranks, each writing its own maps "
                        "(the JAX CLI's data mesh axis)")
    p.add_argument("--spatial", type=int, default=1,
                   help="split each map's rows over N ranks, with halo exchanges (the "
                        "JAX CLI's spatial mesh axis; with --fanout, fanout x N ranks)")
    p.add_argument("--depth_stages", type=int, default=1,
                   help="pipeline depth chunks across N ranks (ConvLSTM carry handed "
                        "over between them; exclusive with --fanout/--spatial and "
                        "--evidential_ckpt)")
    p.add_argument("--pipeline_maps", type=int, default=None,
                   help="maps per depth-pipeline launch (default 2x stages)")
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
    p.add_argument("--batch_size", type=int,
                   help="PER-PROCESS batch size (global = this x num_processes)")
    p.add_argument("--view_num", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--interval_scale", type=float)
    p.add_argument("--image_scale", type=float)
    p.add_argument("--lr", type=float)
    p.add_argument("--depth_block", type=int, help="hypotheses per remat block")
    p.add_argument("--seed", type=int, help="data order")
    p.add_argument("--loadckpt", help="torch .ckpt or orbax directory to start from")
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
                   help="warm-start head weights (torch .ckpt or orbax directory; "
                        "needs --evidential)")
    p.add_argument("--maxdisp", type=int,
                   help="the head's depth hypotheses (default 32; needs --evidential)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    # Data-parallel training across processes, one per card (or on the CPU):
    # torch.distributed, NCCL on cards and gloo with --device cpu.
    p.add_argument("--coordinator", help="host:port of process 0 (multi-process)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--single_device", action="store_true",
                   help="no mesh: each process steps alone on its data shard")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial (height) mesh axis size; data axis = num_processes / "
                        "spatial")
    return p


def _add_fuse(sub):
    p = sub.add_parser("fuse", help="consistency filter + point-cloud fusion")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--test_dataset", choices=["dtu", "tnt", "tnt_padded"], default="dtu")
    p.add_argument("--photo_threshold", type=float,
                   help="confidence threshold (default 0.35 dtu, 0.2 tnt; tnt_padded "
                        "always uses 0.3, as the JAX CLI does)")
    p.add_argument("--num_workers", type=int, default=8,
                   help="threads reading a scan's maps, images and cameras")
    p.add_argument("--host_id", type=int, default=0, help="scan-shard index")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--view_block", type=int, default=None,
                   help="fuse only this contiguous ref-view block of each scan "
                        "(0-based); writes <ply>.block<I>of<N>; run 'fuse' once more "
                        "with --merge_blocks after all blocks finish")
    p.add_argument("--num_view_blocks", type=int, default=1,
                   help="total ref-view blocks per scan")
    p.add_argument("--merge_blocks", action="store_true",
                   help="merge previously written per-view-block PLYs into the final "
                        "per-scan cloud (vertex order identical to a single fuse)")
    p.add_argument("--display", action="store_true",
                   help="show ref image + photo/geo/final masks per view in a cv2 "
                        "window (needs a GUI); not with tnt_padded")
    p.add_argument("--save_masks", action="store_true",
                   help="write photo/geo/final masks as PNGs under <outdir>/<scan>/mask/")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails where there is no card")
    return p


def _add_convert(sub):
    p = sub.add_parser("convert", help="orbax checkpoint -> torch .ckpt")
    p.add_argument("--ckpt", required=True,
                   help="orbax directory: params, a cli train step, or a train logdir "
                        "(its highest step)")
    p.add_argument("--out", required=True, help="output torch .ckpt")
    p.add_argument("--evidential", action="store_true",
                   help="the evidential head's variables, written under evidential.* keys")
    return p


def _add_analyze(sub):
    p = sub.add_parser("analyze", help="offline uncertainty analytics over "
                                       "a train logdir's .npz dumps")
    p.add_argument("--logdir", required=True)
    p.add_argument("--mode", default="train", choices=["train", "fulltest"])
    p.add_argument("--out", help="report directory (default <logdir>/analysis)")
    p.add_argument("--error_threshold", type=float, default=2.0,
                   help="depth-error threshold (mm) for ROC/PR labels")
    return p


def _add_viz(sub):
    p = sub.add_parser("viz", help="module summary and graphviz DOT of the "
                                   "parameter tree")
    p.add_argument("--out", default="viz", help="output directory")
    p.add_argument("--loadckpt", help="checkpoint whose parameter tree is graphed "
                                      "(torch .ckpt or orbax directory; default: "
                                      "a fresh init)")
    p.add_argument("--maxdisp", type=int, default=32)
    return p


def _add_quality(sub):
    p = sub.add_parser("quality", help="accuracy/completeness of a fused PLY "
                                       "vs a ground-truth point cloud")
    p.add_argument("--ply", required=True, help="predicted point cloud (.ply)")
    p.add_argument("--gt", required=True, help="ground-truth point cloud (.ply)")
    p.add_argument("--max_dist", type=float, default=20.0,
                   help="outlier clamp distance (DTU convention: 20 mm)")
    p.add_argument("--downsample", type=float, default=0.2,
                   help="voxel size for pre-filter downsampling (0 = off)")
    return p


def _load(flag: str, loader, module, path):
    """``loader(module, path)``, a checkpoint the loaders cannot read
    refused by the flag's name."""
    from .models.convert import UnreadableCheckpoint

    try:
        return loader(module, path)
    except UnreadableCheckpoint as exc:
        raise SystemExit(f"{flag} {exc}") from exc


def _check_eval_ranks(args) -> None:
    """The multi-rank flags of ``eval``, refused by name where they cannot
    work."""
    for flag in ("fanout", "spatial", "depth_stages", "pipeline_maps"):
        value = getattr(args, flag)
        if value is not None and value < 1:
            raise SystemExit(f"--{flag} {value}: must be at least 1")
    if args.depth_stages > 1 and (args.fanout > 1 or args.spatial > 1):
        raise SystemExit("--depth_stages is exclusive with --fanout/--spatial")


def cmd_eval(args):
    _check_eval_ranks(args)
    cfg = _eval_preset(args)
    if args.dry_check:
        from .data.validate import check_dataset_root

        with open(args.testlist) as f:
            scans = [line.strip() for line in f if line.strip()]
        report = check_dataset_root(args.testpath, scans, padded=cfg.pad_vertical)
        print(report.summary())
        if not report.ok:
            raise SystemExit(1)
        return
    if not args.loadckpt:
        raise SystemExit("--loadckpt is required (or use --dry_check)")
    ranks = args.fanout * args.spatial * args.depth_stages
    if ranks == 1:
        _eval(args, cfg)
    else:
        _spawn_eval(args, ranks)


def _spawn_eval(args, ranks: int) -> None:
    """Start ``ranks`` processes of ``eval`` on a free port of localhost and
    wait for them; a rank that fails ends the others and the command."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from .cli import _eval_rank  # by the package's name, which the ranks import
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "nccl" if cards >= ranks else "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    axis = " ".join(f"--{flag} {getattr(args, flag)}"
                    for flag in ("fanout", "spatial", "depth_stages") if getattr(args, flag) > 1)
    where = ("the CPU" if device.type == "cpu"
             else ", ".join(f"cuda:{k % cards}" for k in range(ranks)))
    print(f"eval: {ranks} ranks ({axis}) on torch.distributed, backend {backend}, "
          f"ranks on {where}", flush=True)
    try:
        mp.start_processes(_eval_rank, args=(args, ranks, port, backend), nprocs=ranks,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        raise SystemExit(f"eval: a rank failed: {exc}") from exc


def _eval_rank(rank: int, args, ranks: int, port: int, backend: str) -> None:
    """One rank of a multi-rank ``eval``: joins the process group, takes its
    card and runs ``eval`` under the mesh of ``--fanout`` and ``--spatial``,
    or of ``--depth_stages``."""
    import torch

    from .parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(f"localhost:{port}", ranks, rank, backend=backend)
    try:
        mesh = make_mesh(data=args.fanout, spatial=args.spatial, depth=args.depth_stages,
                         device=args.device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        _eval(args, _eval_preset(args), mesh)
    finally:
        torch.distributed.destroy_process_group()


def _eval_preset(args):
    from .utils.config import eval_preset

    overrides = {
        k: v
        for k, v in (
            ("nviews", args.view_num), ("ndepths", args.numdepth),
            ("max_h", args.max_h), ("max_w", args.max_w),
            ("depth_block", None if args.depth_block == "auto" else args.depth_block),
            ("interval_scale", args.interval_scale),
            ("inverse_depth", True if args.inverse_depth else None),
        )
        if v is not None
    }
    return eval_preset(args.preset, **overrides)


def _eval(args, cfg, mesh=None) -> None:
    """``eval`` past its checks: the model, the dataset and
    ``run_inference``, in this process or as one rank of ``mesh``."""
    import torch

    from .data.eval_dataset import EvalDataset
    from .models.convert import load_evidential_checkpoint, load_reference_checkpoint
    from .models.evidential import EvidentialHead
    from .models.network import AARMVSNetCore
    from .pipeline.infer import InferConfig, run_inference
    from .utils.config import derive_depth_block, memory_budget
    from .utils.device import resolve_device

    head = None
    if args.evidential_ckpt:
        head = _load("--evidential_ckpt", load_evidential_checkpoint, EvidentialHead(),
                     args.evidential_ckpt)
    depth_source = args.depth_source or ("evidential" if head is not None else "wta")
    if depth_source == "evidential" and head is None:
        raise SystemExit("--depth_source evidential requires --evidential_ckpt")

    # The JAX CLI's precedence: int8 tables over fp8; a dual residual over
    # int8, int8 over fp8.
    table_dtype = (torch.int8 if args.int8_tables
                   else torch.float8_e4m3fn if args.fp8_tables else None)
    residual_dtype = ("dual" if args.dual_residual
                      else torch.int8 if args.int8_residual
                      else torch.float8_e4m3fn if args.fp8_residual else None)
    if args.depth_block == "auto":
        # The estimate of the path these flags ask for, on this device.
        packed = args.packed_rows is not False
        cfg.depth_block = derive_depth_block(
            cfg.max_h, cfg.max_w, cfg.nviews, cfg.ndepths,
            budget=memory_budget(resolve_device(args.device)), packed=packed,
            bf16=not args.fp32, table_dtype=table_dtype, residual_dtype=residual_dtype,
            table_taps=args.table_taps, gather_pack=args.gather_pack,
            fused_residual=packed and not args.no_fused_residual,
            collect_volume=head is not None, feature_view_chunk=args.feat_chunk)
        print(f"--depth_block auto: {cfg.depth_block}", flush=True)
    ds = EvalDataset(
        args.testpath, args.testlist, nviews=cfg.nviews, ndepths=cfg.ndepths,
        interval_scale=cfg.interval_scale, inverse_depth=cfg.inverse_depth,
        max_h=cfg.max_h, max_w=cfg.max_w, pad_vertical=cfg.pad_vertical,
    )
    model = _load("--loadckpt", load_reference_checkpoint, AARMVSNetCore(), args.loadckpt)
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
            table_dtype=table_dtype, residual_dtype=residual_dtype,
            feature_view_chunk=args.feat_chunk, save_png_previews=args.save_png,
            mesh=mesh, pipeline_maps=args.pipeline_maps,
        ),
    )
    if mesh is None or mesh.is_main:
        print(f"eval done: {stats['count']} maps, {stats['maps_per_s']:.3f} maps/s",
              flush=True)


def cmd_fuse(args):
    import os

    from .pipeline.fuse import FuseConfig, fuse_scan, fuse_scan_padded, merge_ply_blocks

    block = None
    if args.view_block is not None:
        block = (args.view_block, args.num_view_blocks)

    def block_path(ply, i):
        return f"{ply}.block{i}of{args.num_view_blocks}"

    with open(args.testlist) as f:
        scans = [line.strip() for line in f if line.strip()]
    scans = scans[args.host_id :: args.num_hosts]
    for scan in scans:
        scan_folder = os.path.join(args.testpath, scan)
        depth_folder = os.path.join(args.outdir, scan)
        if args.test_dataset == "dtu":
            thr = args.photo_threshold if args.photo_threshold is not None else 0.35
            scan_id = int("".join(c for c in scan if c.isdigit()) or 0)
            ply = os.path.join(args.outdir, f"mvsnet_{scan_id:03d}_l3.ply")
        else:
            thr = args.photo_threshold if args.photo_threshold is not None else 0.2
            ply = os.path.join(args.outdir, scan + ".ply")

        if args.merge_blocks:
            n = merge_ply_blocks([block_path(ply, i) for i in range(args.num_view_blocks)], ply)
            print(f"{scan}: merged {args.num_view_blocks} blocks, {n} points -> {ply}")
            continue

        out = ply if block is None else block_path(ply, args.view_block)
        if args.test_dataset == "tnt_padded":
            if args.display:
                print("WARNING: --display is not supported by the padded fusion (matching "
                      "the reference, whose fusion_padding.py has no display path); "
                      "ignoring", flush=True)
            n = fuse_scan_padded(scan_folder, depth_folder, out,
                                 FuseConfig(photo_threshold=0.3, num_workers=args.num_workers,
                                            device=args.device),
                                 view_block=block)
        else:
            n = fuse_scan(scan_folder, depth_folder, out,
                          FuseConfig(photo_threshold=thr, num_workers=args.num_workers,
                                     device=args.device),
                          view_block=block, save_masks=args.save_masks, display=args.display)
        print(f"{scan}: {n} points -> {out}")


def cmd_quality(args):
    import json

    from .core.ply import read_ply
    from .utils.quality import accuracy_completeness

    pred_xyz, _ = read_ply(args.ply)
    gt_xyz, _ = read_ply(args.gt)
    metrics = accuracy_completeness(
        pred_xyz, gt_xyz, max_dist=args.max_dist, downsample=args.downsample
    )
    print(json.dumps(metrics, indent=2))


def check_global_batch(batch_size: int, num_processes: int, data_size: int,
                       num_devices: int, spatial: int = 1) -> None:
    """The JAX CLI's refusal of a global batch (``batch_size`` per process
    times the processes) that the mesh's data axis (the devices over
    ``spatial``) does not divide.  The port runs one process per card, so
    this fails only where ``spatial`` does not divide the processes."""
    global_batch = batch_size * num_processes
    if global_batch % data_size:
        raise SystemExit(
            f"global batch {global_batch} (= {batch_size} x {num_processes} "
            f"processes) must be divisible by the data mesh axis "
            f"({data_size} = {num_devices} devices / spatial {spatial})"
        )


def _check_processes(args) -> None:
    """The multi-process flags, refused by name where they cannot work."""
    if args.num_processes < 1:
        raise SystemExit(f"--num_processes {args.num_processes}: must be at least 1")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process_id {args.process_id}: must be in "
                         f"[0, --num_processes {args.num_processes})")
    if args.num_processes > 1 and not args.coordinator:
        raise SystemExit(f"--num_processes {args.num_processes} needs --coordinator host:port")
    if args.coordinator is not None and ":" not in args.coordinator:
        raise SystemExit(f"--coordinator {args.coordinator!r}: must be host:port")


def _check_spatial(args) -> None:
    """``train --spatial``, refused by name where it cannot work, before any
    process joins the group: the JAX CLI's global-batch check on the data
    axis ``num_processes / spatial``, one process a rank."""
    from .utils.config import train_preset

    if args.spatial < 1:
        raise SystemExit(f"--spatial {args.spatial}: must be at least 1")
    if args.spatial == 1 or args.single_device:
        return
    data = args.num_processes // args.spatial
    if data == 0:
        raise SystemExit(f"--spatial {args.spatial} needs as many processes, one a rank "
                         f"(--num_processes {args.num_processes})")
    batch_size = args.batch_size or train_preset(args.preset).batch_size
    check_global_batch(batch_size, args.num_processes, data, args.num_processes, args.spatial)
    if args.num_processes % args.spatial:
        raise SystemExit(f"--num_processes {args.num_processes} is no multiple of --spatial "
                         f"{args.spatial}")


def cmd_train(args):
    if not args.evidential:
        given = [f"--{n}" for n in ("head_ckpt", "maxdisp") if getattr(args, n) is not None]
        if given:
            raise SystemExit(f"{', '.join(given)} needs --evidential")
    _check_processes(args)
    _check_spatial(args)

    import torch

    from .parallel.mesh import initialize_distributed

    # Before the first device query, as the JAX CLI's (a no-op for one
    # process): gloo for CPU ranks, NCCL for cards.
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend="gloo" if torch.device(args.device).type == "cpu" else None)
    try:
        _train(args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args):
    import torch
    import torch.distributed as dist

    from .data.dtu import DTUTrainDataset
    from .models.convert import load_evidential_checkpoint, load_reference_checkpoint
    from .models.evidential import EvidentialHead
    from .models.network import AARMVSNetCore
    from .parallel.mesh import local_mesh, make_mesh
    from .pipeline.train import TrainConfig, run_training
    from .utils.config import train_preset

    head = None
    maxdisp = 32 if args.maxdisp is None else args.maxdisp
    if args.evidential:
        # A fresh head from seed 1, as the JAX CLI's PRNGKey(1).
        head = EvidentialHead(maxdisp, generator=torch.Generator().manual_seed(1))
        if args.head_ckpt:
            _load("--head_ckpt", load_evidential_checkpoint, head, args.head_ckpt)

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
        _load("--loadckpt", load_reference_checkpoint, model, cfg.loadckpt)

    nproc = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if args.single_device:
        if nproc > 1:  # each process alone on its shard; rank 0 writes
            mesh = local_mesh(args.device)
    elif nproc > 1:
        mesh = make_mesh(spatial=args.spatial, device=args.device)
        if mesh.is_main:
            print(f"mesh: {mesh.shape} over {nproc} processes ({dist.get_backend()}), "
                  f"global batch {cfg.batch_size * nproc}", flush=True)
    # The S spatial ranks of a data rank step on the same samples, each on
    # its rows, so the data rank's batch is their S per-process batches
    # together: the global batch is --batch_size x processes, as in the JAX
    # CLI, and so is the epoch's length in steps.
    spatial = 1 if mesh is None else mesh.shape["spatial"]
    is_main = mesh is None or mesh.is_main
    logger = None
    if not args.no_tensorboard and is_main:
        from .utils.logging import TrainLogger

        logger = TrainLogger(cfg.logdir)
    config = TrainConfig(
        learning_rate=cfg.learning_rate, lr_min=cfg.lr_min, depth_block=cfg.depth_block,
        epochs=cfg.epochs, batch_size=cfg.batch_size * spatial, num_workers=args.num_workers,
        summary_freq=cfg.summary_freq, max_steps=args.max_steps, logdir=cfg.logdir,
        resume=cfg.resume, seed=cfg.seed, device=args.device,
        evidential=args.evidential, maxdisp=maxdisp, mesh=mesh,
    )
    try:
        stats = run_training(model, ds, config, val_dataset=val_ds, logger=logger, head=head)
    finally:
        if logger is not None:
            logger.close()
    if is_main:
        print(f"train done: steps {stats['start_step']} -> {stats['step']}, "
              f"checkpoints in {cfg.logdir}", flush=True)


def cmd_convert(args):
    from .models.convert import UnreadableCheckpoint, convert_orbax_checkpoint

    try:
        n = convert_orbax_checkpoint(args.ckpt, args.out, evidential=args.evidential)
    except UnreadableCheckpoint as exc:
        raise SystemExit(f"--ckpt {exc}") from exc
    print(f"converted {args.ckpt} -> {args.out} ({n} params)")


def cmd_analyze(args):
    """A training logdir's ``.npz`` dumps through the analytics suite (the
    JAX CLI's ``cmd_analyze``; reference train.py:229-239 and
    evidential/statistics.py)."""
    import glob
    import json
    import os

    import numpy as np

    from .utils import analysis

    dump_dir = os.path.join(args.logdir, "results", args.mode)
    paths = sorted(glob.glob(os.path.join(dump_dir, "*.npz")),
                   key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    if not paths:
        raise SystemExit(f"no dumps under {dump_dir} (train with --summary_freq)")
    out_dir = args.out or os.path.join(args.logdir, "analysis")
    os.makedirs(out_dir, exist_ok=True)

    report = {}
    for path in paths:
        step = os.path.splitext(os.path.basename(path))[0]
        d = np.load(path)
        if not {"depth_est", "depth_gt", "mask"} <= set(d.files):
            continue
        error = d["depth_est"] - d["depth_gt"]
        mask = d["mask"]
        entry = {"error": analysis.summarize(error, np.abs(error), mask)}
        if "alea_1" in d.files and "epis_1" in d.files:
            alea, epis = d["alea_1"], d["epis_1"]
            unc = alea + epis
            entry["uncertainty"] = analysis.summarize(error, unc, mask)
            roc = analysis.uncertainty_roc(error, unc, mask, args.error_threshold)
            pr = analysis.uncertainty_precision_recall(error, unc, mask, args.error_threshold)
            cal = analysis.calibration_curve(error, unc, mask)
            entry["roc_auc"] = roc["auc"]
            entry["average_precision"] = pr["average_precision"]
            entry["ause"] = analysis.sparsification_curve(error, unc, mask)["ause"]
            entry["calibration"] = {"bin_uncertainty": cal["bin_uncertainty"],
                                    "bin_abs_error": cal["bin_abs_error"]}
            entry["regression"] = analysis.regression_fit(error, unc, mask)
            sweep = analysis.precision_recall_vs_threshold(error, unc, mask,
                                                          args.error_threshold)
            entry["pr_vs_threshold"] = {k: sweep[k]
                                        for k in ("precision", "recall", "fraction_kept")}
            analysis.plot_density(os.path.join(out_dir, f"density_{step}.png"),
                                  error, unc, mask)
            ref_img = d["ref_img"] if "ref_img" in d.files else np.zeros_like(d["depth_gt"])
            analysis.plot_report(os.path.join(out_dir, f"report_{step}.png"), ref_img,
                                 d["depth_est"], d["depth_gt"], mask, alea, epis)
            m = mask > 0.5
            entry["means"] = {"aleatoric": float(alea[m].mean()) if m.any() else 0.0,
                              "epistemic": float(epis[m].mean()) if m.any() else 0.0}
        report[step] = entry

    # Across dumps (reference statistics.py:1352-1365 compares scenes; the
    # entries here are training steps).
    means = {s: e["means"] for s, e in report.items() if "means" in e}
    if means:
        analysis.plot_means_comparison(os.path.join(out_dir, "means_comparison.png"), means)

    report_path = os.path.join(out_dir, "report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, default=float)
    print(f"analyzed {len(report)} dumps -> {report_path}")


def cmd_viz(args):
    """The core's and the head's module trees with parameter counts, and a
    graphviz DOT of the core's flax parameter tree (the JAX CLI's
    ``cmd_viz``; reference evidential/visu.py)."""
    import os

    from .models.convert import (
        UnreadableCheckpoint,
        load_reference_checkpoint,
        params_to_jax,
        read_orbax,
    )
    from .models.network import AARMVSNetCore
    from .utils.visualize import model_graph_dot, model_summary

    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "model_summary.txt")
    with open(summary_path, "w") as f:
        f.write(model_summary(maxdisp=args.maxdisp))

    try:
        if args.loadckpt and os.path.isdir(args.loadckpt):
            tree = read_orbax(args.loadckpt)  # graphed as it is, as JAX does
        else:
            import torch

            model = AARMVSNetCore(generator=torch.Generator().manual_seed(0))
            if args.loadckpt:
                load_reference_checkpoint(model, args.loadckpt)
            tree = params_to_jax(model.state_dict())
    except UnreadableCheckpoint as exc:
        raise SystemExit(f"--loadckpt {exc}") from exc
    dot_path = os.path.join(args.out, "model_graph.dot")
    with open(dot_path, "w") as f:
        f.write(model_graph_dot(tree))
    print(f"wrote {summary_path} and {dot_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aa_rmvsnet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_eval(sub)
    _add_fuse(sub)
    _add_train(sub)
    _add_convert(sub)
    _add_analyze(sub)
    _add_quality(sub)
    _add_viz(sub)
    args = parser.parse_args(argv)
    from .utils.optional import MissingPackage

    try:
        {"eval": cmd_eval, "fuse": cmd_fuse, "train": cmd_train, "convert": cmd_convert,
         "analyze": cmd_analyze, "quality": cmd_quality, "viz": cmd_viz}[args.cmd](args)
    except MissingPackage as exc:
        raise SystemExit(f"{args.cmd}: {exc}") from exc


if __name__ == "__main__":
    main()
