"""Keras HDF5 checkpoint reader → packed inference model (the port's copy
of :mod:`qnx.convert.keras_h5`, with numpy leaves).

The reference framework checkpoints via Keras ``ModelCheckpoint`` /
``save_weights`` to HDF5: the stored kernel is the LATENT float tensor —
binarize/ternarize must be re-applied at conversion with the right
per-layer H.  This module ingests those artifacts directly with h5py (no TF
import; h5py is imported at the first read or write, so the module imports
without it) and lowers them through the same conversion pass as native
checkpoints (:mod:`qnx_torch.convert.pack_model`).

Two on-disk formats are supported:

* **legacy Keras 1/2** (`model.save_weights('x.h5')`, the reference's era):
  top-level groups per layer, root attr ``layer_names`` giving model order,
  per-group attr ``weight_names`` (e.g. ``dense_1/kernel:0``);
* **Keras 3** (`.weights.h5`): ``/layers/<auto_name>/vars/<i>``.  The file
  stores no explicit order, so order is reconstructed from the auto-name
  index suffixes per layer type (``dense``, ``dense_1``, …) interleaved by
  the known model topology.

Layers are classified *structurally* (2-D kernel → dense; 4-D → conv; four
equal-length 1-D vars → batchnorm), so renamed subclasses like
``BinaryDense``/``QuantizedConv2D`` map correctly regardless of their names.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from qnx_torch.models.factory import glorot_scale
from qnx_torch.utils.config import Config


@dataclass
class LayerVars:
    kind: str  # dense | conv | bn | other
    name: str
    arrays: list


def _classify(arrays) -> str:
    shapes = [a.shape for a in arrays]
    if not shapes:
        return "other"
    if len(shapes[0]) == 2:
        return "dense"
    if len(shapes[0]) == 4:
        return "conv"
    if len(shapes) == 4 and all(len(s) == 1 for s in shapes) and len(
        {s[0] for s in shapes}
    ) == 1:
        return "bn"
    return "other"


def _read_legacy(f: h5py.File) -> list[LayerVars]:
    root = f["model_weights"] if "model_weights" in f else f
    layer_names = [
        n.decode() if isinstance(n, bytes) else n
        for n in root.attrs["layer_names"]
    ]
    out = []
    for lname in layer_names:
        g = root[lname]
        wnames = [
            n.decode() if isinstance(n, bytes) else n
            for n in g.attrs.get("weight_names", [])
        ]
        arrays = [np.asarray(g[w]) for w in wnames]
        if arrays:
            out.append(LayerVars(_classify(arrays), lname, arrays))
    return out


def _keras3_order_key(name: str) -> tuple:
    m = re.match(r"(.*?)(?:_(\d+))?$", name)
    return (m.group(1), int(m.group(2) or 0))


def _fans(lv: LayerVars) -> tuple[int, int]:
    """(fan_in, fan_out) of a compute layer's kernel: dense (in, out) or
    conv (kh, kw, cin, cout) → (cin, cout)."""
    k = lv.arrays[0]
    return (k.shape[0], k.shape[1]) if lv.kind == "dense" else (
        k.shape[2], k.shape[3])


def _check_chaining(compute: list[LayerVars], bns: list[LayerVars]) -> None:
    """Validate the reconstructed order by kernel-shape chaining: layer i's
    fan_out must feed layer i+1's fan_in (conv→dense flattens spatial, so
    divisibility is the invariant there), and each interleaved BN must have
    vectors sized to its compute layer's fan_out.  The Keras-3 layout stores
    no explicit model order — this turns a silent mis-ordering (e.g. a model
    with non-alternating BN or unexpected extra layers) into a hard error."""
    for i in range(len(compute) - 1):
        a, b = compute[i], compute[i + 1]
        _, out_a = _fans(a)
        in_b, _ = _fans(b)
        ok = (in_b % out_a == 0) if (a.kind == "conv" and b.kind == "dense") \
            else (in_b == out_a)
        if not ok:
            raise ValueError(
                f"reconstructed layer order fails kernel-shape chaining: "
                f"{a.kind} {a.name!r} (fan_out {out_a}) -> {b.kind} "
                f"{b.name!r} (fan_in {in_b}); the checkpoint's topology "
                f"does not match the assumed sequential compute->BN order")
    for lv, bn in zip(compute, bns):
        _, out_c = _fans(lv)
        if bn.arrays[0].shape[0] != out_c:
            raise ValueError(
                f"BN {bn.name!r} has {bn.arrays[0].shape[0]}-channel vectors "
                f"but its compute layer {lv.name!r} has fan_out {out_c}; "
                f"BN interleaving reconstruction is wrong for this file")


def _read_keras3(f: h5py.File) -> list[LayerVars]:
    layers_group = f["layers"]
    named = []
    for lname in layers_group:
        g = layers_group[lname]
        if "vars" not in g or not len(g["vars"]):
            continue
        arrays = [np.asarray(g["vars"][str(i)]) for i in range(len(g["vars"]))]
        named.append(LayerVars(_classify(arrays), lname, arrays))
    # Reconstruct model order.  Keras-3 auto-names carry a per-class index
    # (conv2d, conv2d_1, …, dense, dense_1, …) giving creation order WITHIN
    # a class but not across classes, so sort each kind by its own index and
    # lay out convs before denses — the reference family's only topology
    # (feature extractor -> classifier head).  BN follows each compute layer
    # in creation order, so bns[i] pairs with compute[i].  _check_chaining
    # turns any violation of these assumptions into a hard error instead of
    # a silently mis-ordered model.
    idx = lambda lv: _keras3_order_key(lv.name)[1]
    compute = sorted([lv for lv in named if lv.kind == "conv"], key=idx) + \
        sorted([lv for lv in named if lv.kind == "dense"], key=idx)
    bns = sorted([lv for lv in named if lv.kind == "bn"], key=idx)
    _check_chaining(compute, bns)
    out = []
    for i, lv in enumerate(compute):
        out.append(lv)
        if i < len(bns):
            out.append(bns[i])
    return out


def read_keras_h5(path: str) -> list[LayerVars]:
    """Read a Keras HDF5 weights file into an ordered layer list."""
    import h5py

    with h5py.File(path, "r") as f:
        if "layers" in f:
            return _read_keras3(f)
        if "layer_names" in f.attrs or (
            "model_weights" in f and "layer_names" in f["model_weights"].attrs
        ):
            return _read_legacy(f)
        raise ValueError(f"unrecognized Keras HDF5 layout in {path}")


def _dense_vars(lv: LayerVars):
    kernel = lv.arrays[0]
    bias = lv.arrays[1] if len(lv.arrays) > 1 else None
    return kernel, bias


def _h_for(cf: Config, fan_in: int, fan_out: int) -> float:
    if isinstance(cf.H, str):
        return glorot_scale(fan_in, fan_out)
    return float(cf.H)


def _leaf(a) -> np.ndarray:
    """A leaf as ``jnp.asarray`` makes it without x64: floats in float32."""
    a = np.asarray(a)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def variables_from_keras_h5(path: str, cf: Config) -> dict:
    """Assemble a variables tree (params/quant/batch_stats) of numpy leaves
    from a reference Keras checkpoint, matched against the model family of
    ``cf``: float32 arrays, as the JAX copy's ``jnp`` leaves are, and each
    quantized layer's ``H`` and ``lr_mult`` as ``np.float32``.

    The result feeds straight into pack_mlp/pack_vgg/pack_int8 — checkpoints
    minted by the reference and by qnx training become interchangeable
    artifacts."""
    layers = read_keras_h5(path)
    compute = [lv for lv in layers if lv.kind in ("dense", "conv")]
    bns = [lv for lv in layers if lv.kind == "bn"]
    if len(compute) != len(bns):
        raise ValueError(
            f"expected one BN per compute layer, got {len(compute)} compute "
            f"vs {len(bns)} bn")

    params, quant, stats = {}, {}, {}

    def add_bn(name, lv):
        gamma, beta, mean, var = lv.arrays
        params[name] = {"scale": _leaf(gamma), "bias": _leaf(beta)}
        stats[name] = {"mean": _leaf(mean), "var": _leaf(var)}

    def add_compute(name, lv, quantized, fan_in, fan_out):
        kernel, bias = _dense_vars(lv)
        params[name] = {"kernel": _leaf(kernel)}
        if bias is not None:
            params[name]["bias"] = _leaf(bias)
        if quantized:
            h = _h_for(cf, fan_in, fan_out)
            quant[name] = {"H": np.float32(h),
                           "lr_mult": np.float32(1.0 / h)}

    if cf.architecture == "mlp":
        if len(compute) != cf.num_hidden + 1:
            raise ValueError(
                f"checkpoint has {len(compute)} dense layers; config expects "
                f"{cf.num_hidden + 1}")
        for i in range(cf.num_hidden):
            k = compute[i].arrays[0]
            add_compute(f"dense_{i}", compute[i], True, k.shape[0], k.shape[1])
            add_bn(f"bn_{i}", bns[i])
        k = compute[-1].arrays[0]
        add_compute("dense_out", compute[-1],
                    not cf.last_layer_float, k.shape[0], k.shape[1])
        add_bn("bn_out", bns[-1])
    elif cf.architecture == "vgg":
        n_conv, n_dense = 6, 3
        if len(compute) != n_conv + n_dense:
            raise ValueError(
                f"checkpoint has {len(compute)} compute layers; VGG expects "
                f"{n_conv + n_dense}")
        for i in range(n_conv):
            k = compute[i].arrays[0]  # (kh, kw, cin, cout)
            fan_in = k.shape[0] * k.shape[1] * k.shape[2]
            fan_out = k.shape[0] * k.shape[1] * k.shape[3]
            quantized = not (i == 0 and cf.first_layer_float)
            add_compute(f"conv_{i}", compute[i], quantized, fan_in, fan_out)
            add_bn(f"bn_conv_{i}", bns[i])
        for j in range(2):
            lv = compute[n_conv + j]
            k = lv.arrays[0]
            add_compute(f"dense_{j}", lv, True, k.shape[0], k.shape[1])
            add_bn(f"bn_dense_{j}", bns[n_conv + j])
        lv = compute[-1]
        k = lv.arrays[0]
        add_compute("dense_out", lv, not cf.last_layer_float,
                    k.shape[0], k.shape[1])
        add_bn("bn_out", bns[-1])
    else:
        raise ValueError(f"unknown architecture {cf.architecture!r}")

    return {"params": params, "quant": quant, "batch_stats": stats}


def convert_keras_h5(path: str, cf: Config, device="cuda"):
    """Reference Keras HDF5 checkpoint → packed inference model on
    ``device``."""
    from qnx_torch.convert.pack_model import pack_mlp, pack_vgg

    variables = variables_from_keras_h5(path, cf)
    if cf.architecture == "mlp":
        return pack_mlp(variables, cf, device=device)
    return pack_vgg(variables, cf, device=device)


def write_legacy_h5(path: str, layers: list[tuple[str, list[tuple[str, np.ndarray]]]]):
    """Write a legacy Keras-1/2-format weights file (layer_names /
    weight_names attrs). Used by tests to mint reference-shaped artifacts
    and as a migration utility."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [n.encode() for n, _ in layers], dtype="S64")
        for lname, weights in layers:
            g = f.create_group(lname)
            g.attrs["weight_names"] = np.array(
                [wn.encode() for wn, _ in weights], dtype="S96")
            for wname, arr in weights:
                g.create_dataset(wname, data=arr)
