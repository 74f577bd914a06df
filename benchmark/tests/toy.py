"""The cells at a size a CPU test run holds: every width as published, the
map, the views, the hypotheses and the head's ``maxdisp`` cut."""

from __future__ import annotations

from benchmark import manifest as manifests

TOY = dict(height=32, width=40, views=3, num_depth=16, depth_block=8, maxdisp=8)


def work(name: str) -> dict:
    w = manifests.cell(manifests.load(), name)
    w["config_data"].update(TOY)
    # Cameras closer together at the toy focal length, so that the packed
    # gate passes as at full size.
    w["traffic_params"].update(focal=40.0, baseline=0.5 if w["driver"] == "eval" else 2.0)
    if w["driver"] == "eval":
        # Fewer hypotheses read a smaller gap: at 16 the fp8 control and a
        # dropped GroupNorm affine read near the card's limit, at 32 above.
        w["config_data"]["num_depth"] = 32
    return w


#: The eval cells' program on its exact fp32 path (no packed warp), which
#: computes what the reference computes.
EXACT = {"infer": {"feature_dtype": "float32", "packed_rows": False, "fused_residual": False},
         "mode": [False, 1, 4]}
