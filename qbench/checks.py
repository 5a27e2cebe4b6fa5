"""What decides a run: that its process loaded no JAX, and that the served
answers are the reference's.

The served answer of an image is its logits row.  The reference computes
the float layers in float64; the program in float32, so a first-layer
pre-activation within float32's rounding of its threshold can take the
other code, and the difference can reach the logits.  So an image is
judged equal when every logit lies within the port's logit gate of the
reference's (``ATOL_REL`` of the image's largest |logit|, plus ``RTOL`` of
the logit), and the number compared is the share of checked images that
are not: a limit between what sound runs read over many seeds and what
the control (the reference in TF32) reads, set in the configuration's
file.
"""
from __future__ import annotations

import numpy as np
import torch

#: top-level module names no run may load: the JAX package and JAX's stack
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "qnx")

ATOL_REL = 1e-4   # of the image's largest |logit|
RTOL = 1e-5
REF_BLOCK = 512   # images a reference call


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module ``names``: each name's
    part before its first dot, compared whole (``qnx_torch`` is not
    ``qnx``)."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def mismatched(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """One bool an image: some logit of ``prog`` outside the gate around
    ``ref``."""
    ref = np.asarray(ref, np.float64)
    tol = ATOL_REL * np.abs(ref).max(axis=1, keepdims=True) + RTOL * np.abs(ref)
    return (np.abs(np.asarray(prog, np.float64) - ref) > tol).any(axis=1)


def reference_in_blocks(arch, spec: dict, variables: dict, images: np.ndarray,
                        device, precision: str = "exact") -> np.ndarray:
    """The reference's logits of NHWC uint8 ``images``, ``REF_BLOCK`` at a
    time on ``device``."""
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), REF_BLOCK):
            x = torch.from_numpy(images[i:i + REF_BLOCK]).to(device)
            out.append(arch.reference_logits(spec, variables, x, precision).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, spec["classes"]))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``{name: {"value", "limit"}}`` for each number compared, and whether
    every value is within its limit (``checked_images`` is a least count)."""
    checks = {
        "unanswered": {"value": readings["unanswered"], "limit": limits["unanswered"]},
        "logit_mismatch_share": {"value": readings["logit_mismatch_share"],
                                 "limit": limits["logit_mismatch_share"]},
        "checked_images": {"value": readings["checked_images"], "least": 1},
    }
    ok = (checks["unanswered"]["value"] <= checks["unanswered"]["limit"]
          and checks["checked_images"]["value"] >= 1
          and checks["logit_mismatch_share"]["limit"] is not None
          and checks["logit_mismatch_share"]["value"]
          <= checks["logit_mismatch_share"]["limit"])
    return ok, checks
