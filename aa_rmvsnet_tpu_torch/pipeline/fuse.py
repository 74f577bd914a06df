"""Photometric + geometric consistency filtering and point-cloud fusion
(port of ``aa_rmvsnet_tpu/pipeline/fuse.py``).

Consumes the per-view depth/confidence PFMs of ``run_inference`` plus the
scene's images and cameras and emits a fused PLY point cloud, with the
JAX package's numerics (reference: fusion.py:27-289):

- the reference image is resized and center-cropped to the *prediction's*
  geometry, inferred from the confidence-map/image size ratio, with the
  intrinsics adjusted (fusion.py:157-175);
- photometric mask: ``confidence > threshold`` (0.35 DTU / 0.2 TnT);
- geometric check per source view: project the reference pixels into the
  source with the estimated depth, sample the source depth bilinearly,
  project back, and require a reprojection distance < i/4 px AND a
  relative depth difference < i/1300 for the graduated levels i in
  [2, 10] (fusion.py:110-133);
- a pixel survives if >= i source views pass level i for some i (for
  ``i <= len(src_views) + 1``);
- fused depth = mean of the reference estimate and the reprojections
  that pass the loosest level;
- surviving pixels are back-projected to world space with the reference
  image's color.

The reproject-and-vote runs on the card, in the kernel of
``ops/fusion.py`` (one launch per reference view), with the arithmetic of
the JAX package's C++ core (``native/fusion_core.cpp``); on the CPU its
plain version gives the same bits.  The JAX package's second path (numpy
and ``cv2.remap``, ``FuseConfig(use_native=False)``), which quantises the
sample coordinates to 1/32 px and which it takes only where its C++ core
is not built, is refused: the port has the core's arithmetic on every
device.  Everything after decoding
runs as torch ops on the fusion device, the ``cv2`` image operations
included (``ops/image.py``); ``cv2`` is imported only to read JPEGs and to
show or write masks.  :func:`fuse_views` is the in-memory entry point;
:func:`fuse_scan` and :func:`fuse_scan_padded` read a scene's files (on
``num_workers`` threads) and call it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..core.cameras import read_cam_file, read_pair_file
from ..core.pfm import read_pfm
from ..core.ply import read_ply, write_ply
from ..ops.fusion import fuse_ref, level_thresholds, pair_matrices, pair_terms
from ..ops.image import pyr_down, resize_linear
from ..ops.patch_sample import true_div
from ..utils.device import resolve_device


@dataclass
class FuseConfig:
    photo_threshold: float = 0.35  # 0.35 DTU / 0.2 TnT (fusion.py:285-288)
    dist_base: float = 4.0  # level-i pixel threshold = i / dist_base
    rel_diff_base: float = 1300.0  # level-i relative depth threshold = i / base
    num_levels: int = 9  # graduated levels i in [2, 2+num_levels)
    num_workers: int = 8  # threads reading the scene's files
    use_native: bool = True  # the C++ core's arithmetic; False is refused
    device: str = "cuda"


def _pair_block(pairs, block: int, num_blocks: int):
    """CONTIGUOUS slice of the (ref, srcs) pair list for worker ``block`` of
    ``num_blocks``.  Contiguous (not strided) so concatenating the per-block
    PLYs in block order reproduces the single-host vertex order exactly."""
    if not 0 <= block < num_blocks:
        raise ValueError(f"view block {block} outside [0, {num_blocks})")
    n = len(pairs)
    return pairs[block * n // num_blocks : (block + 1) * n // num_blocks]


def merge_ply_blocks(block_paths, out_path: str) -> int:
    """Concatenate per-view-block PLYs (every block's vertices are already
    in world space) into one cloud.  Returns the vertex count."""
    xyz, rgb = [], []
    for path in block_paths:
        x, c = read_ply(path)
        xyz.append(x)
        rgb.append(c)
    xyz = np.concatenate(xyz) if xyz else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(rgb) if rgb else np.zeros((0, 3), np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_ply(out_path, xyz, rgb)
    return len(xyz)


def _pair_on_cpu(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    return pair_terms(torch.as_tensor(np.asarray(depth_ref, np.float32)),
                      torch.as_tensor(np.asarray(depth_src, np.float32)),
                      pair_matrices(K_ref, E_ref, K_src, E_src).tolist())


def reproject_with_depth(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """Ref->src->ref round trip of one pair (reference fusion.py:71-108), on
    the CPU, with the C++ core's arithmetic.

    Returns ``(depth_reprojected, x_reprojected, y_reprojected)`` as
    ``(H, W)`` float32 maps.
    """
    _, _, depth, x, y = _pair_on_cpu(depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    return tuple(t.float().numpy() for t in (depth, x, y))


def graduated_consistency(depth_ref, K_ref, E_ref, depth_src, K_src, E_src,
                          config: FuseConfig):
    """Graduated masks + loosest-mask-zeroed reprojected depth of one pair
    (reference fusion.py:110-133), on the CPU, with the C++ core's
    arithmetic: a list of ``(H, W)`` bool masks, one per level, and the
    ``(H, W)`` float32 reprojected depth."""
    dist, rel, depth, _, _ = _pair_on_cpu(depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    masks = [((dist < dt) & (rel < rt)).numpy()
             for dt, rt in level_thresholds(config.num_levels, config.dist_base,
                                            config.rel_diff_base)]
    return masks, np.where(masks[-1], depth.float().numpy(), np.float32(0.0))


def _align_image_to_prediction(img: torch.Tensor, conf_shape):
    """Resize + center-crop the full-res ``(H, W, 3)`` float32 scene image to
    the prediction's geometry, returning the image and the (scale, crop
    index, axis flag) needed to adjust intrinsics (reference
    fusion.py:157-175)."""
    h, w = img.shape[:2]
    scale = conf_shape[0] / h
    index = int((int(w * scale) - conf_shape[1]) / 2)
    flag = 0
    if conf_shape[1] / w > scale:
        scale = conf_shape[1] / w
        index = int((int(h * scale) - conf_shape[0]) / 2)
        flag = 1
    resized = resize_linear(img, int(w * scale), int(h * scale))
    if flag == 0:
        index_p = resized.shape[1] - conf_shape[1] - index
        out = resized[:, index : resized.shape[1] - index_p]
    else:
        index_p = resized.shape[0] - conf_shape[0] - index
        out = resized[index : resized.shape[0] - index_p, :]
    return out, scale, index, flag


def _adjust_intrinsics(K: np.ndarray, scale, index, flag) -> np.ndarray:
    K = K.copy()
    K[:2, :] *= scale
    if flag == 0:
        K[0, 2] -= index
    else:
        K[1, 2] -= index
    return K


def _back_project(xs, ys, ds, K: np.ndarray, E: np.ndarray) -> torch.Tensor:
    """World points of pixels ``(xs, ys)`` at depths ``ds`` (float64): the
    JAX package's ``inv(K) @ ([x, y, 1] * d)`` and ``inv(E) @ [., 1]``,
    with the inverses in K's and E's own dtype, in float64; ``(N, 3)``
    float32."""
    kinv = np.linalg.inv(K).astype(np.float64).tolist()
    einv = np.linalg.inv(E).astype(np.float64).tolist()
    v = (xs * ds, ys * ds, ds)
    cam = [r[0] * v[0] + r[1] * v[1] + r[2] * v[2] for r in kinv]
    world = [r[0] * cam[0] + r[1] * cam[1] + r[2] * cam[2] + r[3] for r in einv[:3]]
    return torch.stack(world, dim=1).float()


def fuse_views(depths: dict, confidences: dict, images: dict, cams: dict, pairs,
               config: FuseConfig = FuseConfig(), padded: bool = False,
               empty_ok: bool = False, name: str = "the views", on_masks=None):
    """Filter + fuse views held in memory into one point cloud.

    Args:
      depths, confidences: ``{view: (H, W) float32}`` maps as
        ``run_inference`` writes them (numpy or torch); a view without a
        depth map is left out.
      images: ``{view: (h, w, 3) uint8}`` RGB images of the reference views
        at their full resolution.
      cams: ``{view: (K, E)}``, 3x3 intrinsics and 4x4 world-to-camera
        extrinsics as ``read_cam_file`` gives them (float32).
      pairs: ``[(ref_view, [src_views])]``; the vertices come out in this
        reference order.
      padded: the TnT padded pipeline's variant (reference
        fusion_padding.py): crop 2 rows top and bottom of every map, halve
        the intrinsics, ``pyr_down`` the image, and add ``loose count >=
        10`` to the graduated test, which counts every level.
      empty_ok: return an empty cloud where no reference view has a depth
        map and a source, instead of raising ``RuntimeError`` about
        ``name``.
      on_masks: called as ``on_masks(ref_view, image, photo, geo, final)``
        with host numpy arrays per fused reference view.

    Returns:
      ``(xyz, rgb)``: ``(N, 3)`` float32 world points and ``(N, 3)`` uint8
      colors, numpy.
    """
    if not config.use_native:
        raise NotImplementedError(
            "FuseConfig(use_native=False): the port has no numpy/cv2.remap fusion path. "
            "It computes the C++ core's arithmetic on every device (the kernel on the "
            "card, its plain version on the CPU); the JAX package takes that path only "
            "where its C++ core is not built")
    dev = resolve_device(config.device)

    def crop(a):
        a = torch.as_tensor(np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a)
        return a[2:-2, :] if padded else a

    views = sorted(v for v in depths if depths[v] is not None)
    slot = {v: i for i, v in enumerate(views)}
    stack = (torch.stack([crop(depths[v]) for v in views]).to(dev, torch.float32).contiguous()
             if views else None)
    h, w = (stack.shape[1:] if views else (0, 0))
    ys_grid = xs_grid = None
    xyz, rgb, fused = [], [], 0
    for ref, srcs in pairs:
        if ref not in slot:
            continue
        present = [s for s in srcs if s in slot]
        if not present:
            continue
        fused += 1
        conf = crop(confidences[ref]).to(dev)
        img = torch.as_tensor(images[ref]).to(dev)
        K_ref, E_ref = cams[ref]
        if padded:
            img = true_div(pyr_down(img).float(), 255.0)[:h, :w]
            K_ref = K_ref.copy()
            K_ref[:2, :] /= 2.0
            src_K = {s: cams[s][0].copy() for s in present}
            for K in src_K.values():
                K[:2, :] /= 2.0
        else:
            img, scale, index, flag = _align_image_to_prediction(
                true_div(img.float(), 255.0), tuple(conf.shape))
            K_ref = _adjust_intrinsics(K_ref, scale, index, flag)
            src_K = {s: _adjust_intrinsics(cams[s][0], scale, index, flag) for s in present}

        mats = np.stack([pair_matrices(K_ref, E_ref, src_K[s], cams[s][1]) for s in present])
        counts, loose, reproj_sum = fuse_ref(
            stack, slot[ref], torch.tensor([slot[s] for s in present], dtype=torch.int32,
                                           device=dev),
            torch.from_numpy(mats).to(dev), config.num_levels, config.dist_base,
            config.rel_diff_base)

        photo = conf > config.photo_threshold
        geo = loose >= 10 if padded else torch.zeros_like(photo)
        for li, i in enumerate(range(2, 2 + config.num_levels)):
            if padded or i <= len(srcs) + 1:
                geo |= counts[li] >= i
        ref_depth = stack[slot[ref]]
        fused_depth = (reproj_sum + ref_depth).double() / (loose + 1).double()
        final = photo & geo
        if on_masks is not None:
            on_masks(ref, img.cpu().numpy(), photo.cpu().numpy(), geo.cpu().numpy(),
                     final.cpu().numpy())

        if ys_grid is None:
            ys_grid, xs_grid = (g.double() for g in torch.meshgrid(
                torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"))
        xyz.append(_back_project(xs_grid[final], ys_grid[final], fused_depth[final],
                                 K_ref, E_ref).cpu())
        rgb.append((img[final] * 255.0).to(torch.uint8).cpu())

    if not fused and not empty_ok:
        raise RuntimeError(f"no fused points for {name} (missing depth maps?)")
    if not xyz:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return torch.cat(xyz).numpy(), torch.cat(rgb).numpy()


def _read_rgb(path) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _read_scene(scan_folder: str, depth_folder: str, pairs, num_workers: int):
    """The depth and confidence maps, reference images and cameras that
    ``pairs`` reads, loaded on ``num_workers`` threads."""
    refs = [r for r, _ in pairs]
    views = sorted({v for r, s in pairs for v in [r, *s]})

    def depth(v):
        path = os.path.join(depth_folder, f"depth_est_0/{v:08d}.pfm")
        return read_pfm(path)[0] if os.path.exists(path) else None

    def cam(v):
        c = read_cam_file(os.path.join(scan_folder, f"cams/{v:08d}_cam.txt"))
        return c.intrinsics, c.extrinsics

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        depths = dict(zip(views, pool.map(depth, views)))
        depths = {v: d for v, d in depths.items() if d is not None}
        have = [r for r in refs if r in depths]
        confidences = dict(zip(have, pool.map(lambda v: read_pfm(os.path.join(
            depth_folder, f"confidence_0/{v:08d}.pfm"))[0], have)))
        images = dict(zip(have, pool.map(lambda v: _read_rgb(os.path.join(
            scan_folder, f"images/{v:08d}.jpg")), have)))
        cams = dict(zip(views, pool.map(cam, views)))
    return depths, confidences, images, cams


def _write_cloud(ply_path: str, xyz, rgb) -> int:
    os.makedirs(os.path.dirname(ply_path) or ".", exist_ok=True)
    write_ply(ply_path, xyz, rgb)
    return len(xyz)


def fuse_scan_padded(
    scan_folder: str,
    depth_folder: str,
    ply_path: str,
    config: FuseConfig | None = None,
    num_workers: int = 8,
    view_block: tuple[int, int] | None = None,
) -> int:
    """TnT padded-pipeline fusion variant (reference fusion_padding.py:29-266).

    Matched to the row-padding eval dataset: predictions are at half the
    original image resolution with 8 padded rows (so 4 rows at half-res);
    the variant crops 2 rows top/bottom of every prediction, halves the
    intrinsics, pyrDowns the reference image, uses photo threshold 0.3, and
    adds a fixed ``loose-mask sum >= 10`` term to the graduated OR.
    ``view_block=(block, num_blocks)`` fuses one contiguous ref-view block
    (see :func:`fuse_scan`).  Returns the vertex count.
    """
    if config is None:
        config = FuseConfig(photo_threshold=0.3, num_workers=num_workers)
    pairs = read_pair_file(os.path.join(scan_folder, "pair.txt"))
    if view_block is not None:
        pairs = _pair_block(pairs, *view_block)
    scene = _read_scene(scan_folder, depth_folder, pairs, config.num_workers)
    xyz, rgb = fuse_views(*scene, pairs, config, padded=True,
                          empty_ok=view_block is not None, name=scan_folder)
    return _write_cloud(ply_path, xyz, rgb)


def fuse_scan(
    scan_folder: str,
    depth_folder: str,
    ply_path: str,
    config: FuseConfig = FuseConfig(),
    save_masks: bool = False,
    view_block: tuple[int, int] | None = None,
    display: bool = False,
) -> int:
    """Filter + fuse one scan into a PLY file.  Returns the vertex count.

    ``scan_folder``: the scene dir (images/, cams/, pair.txt).
    ``depth_folder``: the inference output dir (depth_est_0/, confidence_0/).
    ``view_block``: optional ``(block, num_blocks)``: fuse only that
    contiguous ref-view block (distributing ONE large scan across hosts);
    merge the per-block PLYs afterwards with :func:`merge_ply_blocks`.  A
    block may fuse zero points; it still writes its (empty) PLY.
    ``save_masks``: write the photo / geo / final masks of each reference
    view as PNGs under ``<depth_folder>/mask/``.
    ``display``: show ref image | photo | geo | final masks per ref view
    in a ``cv2`` window (reference fusion.py:238-244 ``--display``); needs
    a GUI-capable ``cv2``.
    """
    pairs = read_pair_file(os.path.join(scan_folder, "pair.txt"))
    if view_block is not None:
        pairs = _pair_block(pairs, *view_block)
    scene = _read_scene(scan_folder, depth_folder, pairs, config.num_workers)

    def on_masks(ref_view, img, photo, geo, final):
        import cv2

        if display:
            panes = [np.ascontiguousarray((img[..., ::-1] * 255).astype(np.uint8))] + [
                cv2.cvtColor((m * np.uint8(255)).astype(np.uint8), cv2.COLOR_GRAY2BGR)
                for m in (photo, geo, final)
            ]
            try:
                cv2.imshow(f"ref {ref_view:08d}  img | photo | geo | final",
                           np.concatenate(panes, axis=1))
                cv2.waitKey(0)
                cv2.destroyAllWindows()
            except cv2.error as e:
                raise RuntimeError(
                    "--display needs a GUI-capable OpenCV/display; on a headless host "
                    "use save_masks (writes the same masks as PNGs)") from e
        if save_masks:
            os.makedirs(os.path.join(depth_folder, "mask"), exist_ok=True)
            for tag, m in (("photo", photo), ("geo", geo), ("final", final)):
                cv2.imwrite(os.path.join(depth_folder, f"mask/{ref_view:08d}_{tag}.png"),
                            m.astype(np.uint8) * 255)

    xyz, rgb = fuse_views(*scene, pairs, config, empty_ok=view_block is not None,
                          name=scan_folder,
                          on_masks=on_masks if (display or save_masks) else None)
    return _write_cloud(ply_path, xyz, rgb)
