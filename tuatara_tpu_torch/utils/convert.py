"""Weight conversion: reference TorchScript / torch checkpoints -> the
engine's npz weights directory (port of `tuatara_tpu/utils/convert.py`).

The reference ships its models as TorchScript artifacts
(`craft_traced_torchscript_model.pt`, `parseq_torchscript.bin`). This module
converts their parameters once into the weights directory both packages
serve: JAX's tree layout (conv kernels HWIO, linear weights [in, out],
separate q/k/v projections, CRAFT's BatchNorms unfolded as {scale, bias,
mean, var}), written by the port's own `utils/weights.save_weights_dir`.

Name maps follow the public upstream networks the artifacts were traced
from:
* CRAFT (clovaai/CRAFT-pytorch): `basenet.sliceN.<torchvision vgg16_bn
  index>` for the backbone, `upconvN.conv.<index>` double convs,
  `conv_cls.<index>` head.
* PARSEQ (baudm/parseq): a timm ViT encoder (`encoder.blocks.N...`, fused
  qkv) and the dual-stream decoder (`decoder.layers.0...`,
  nn.MultiheadAttention's fused in_proj).

The patch-embed convolution becomes the patchify product's [ph*pw*3, D]
matrix, features in (ph, pw, c) order, as `models/parseq.py` reshapes.

`probe_input_normalization` finds which input transform the traced graph
applies inside (identity, PARSEQ's 2x-1, ImageNet's mean/std in either
channel order) by running the traced module on the CPU and the port's own
fp32 forward, on the engine's device, over the same inputs; a transform
found is baked into the saved config's `input_mean` / `input_std`.
"""

from __future__ import annotations

import dataclasses
import difflib
import logging
import os
import re
from typing import Any, Dict, Optional, Sequence

import numpy as np

from tuatara_tpu_torch.config import CraftConfig, ParseqConfig

CRAFT_ARTIFACT = "craft_traced_torchscript_model.pt"
PARSEQ_ARTIFACT = "parseq_torchscript.bin"


class _StateDict(dict):
    """A state dict whose missing key raises with the nearest actual keys
    listed, so that an artifact whose names differ from the upstream ones
    is diagnosable from the message alone."""

    def __missing__(self, key):
        near = difflib.get_close_matches(key, list(self.keys()), n=5, cutoff=0.3)
        raise KeyError(
            f"checkpoint key {key!r} not found. Nearest actual keys: {near}. "
            f"({len(self)} keys total; if they carry an unrecognized wrapper "
            f"prefix, pass the state_dict through _strip_wrapper_prefixes "
            f"with the right anchor, or strip it manually)")


def _strip_wrapper_prefixes(sd: Dict[str, Any], anchors: Sequence[str]) -> Dict[str, Any]:
    """Strip a common wrapper prefix (a tracing wrapper's attribute,
    Lightning's 'model.', DataParallel's 'module.', nested) so that keys
    start at one of the `anchors`. A no-op when keys are anchored already;
    the dict comes back unchanged when no anchor is found anywhere (the
    later KeyError then lists the real keys)."""
    keys = list(sd.keys())
    if not keys or any(k.startswith(a) for a in anchors for k in keys):
        return sd
    for a in anchors:
        for k in keys:
            i = k.find("." + a)
            if i < 0:
                continue
            prefix = k[: i + 1]
            return {(kk[len(prefix):] if kk.startswith(prefix) else kk): v
                    for kk, v in sd.items()}
    return sd


def _conv(w, b=None) -> Dict[str, np.ndarray]:
    p = {"w": np.transpose(np.asarray(w), (2, 3, 1, 0)).astype(np.float32)}
    if b is not None:
        p["b"] = np.asarray(b).astype(np.float32)
    return p


def _bn(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
            "mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
            "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)}


def _linear(sd, prefix) -> Dict[str, np.ndarray]:
    p = {"w": np.asarray(sd[f"{prefix}.weight"], np.float32).T}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return p


def _ln(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


# torchvision vgg16_bn conv feature indices in trunk order, and the CRAFT
# slice each lives in (slice1: [0, 12), slice2: [12, 19), slice3: [19, 29),
# slice4: [29, 39)).
VGG_CONV_IDX = [0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37]
VGG_NAMES = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
             "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2"]
HEAD_IDX = [0, 2, 4, 6, 8]


def slice_of(idx: int) -> str:
    if idx < 12:
        return "slice1"
    if idx < 19:
        return "slice2"
    if idx < 29:
        return "slice3"
    return "slice4"


def convert_craft_state_dict(sd: Dict[str, Any], cfg: CraftConfig = CraftConfig()):
    """clovaai-CRAFT state dict -> the CRAFT tree (BatchNorms unfolded).
    Wrapper prefixes ('module.', 'model.', a tracing wrapper's attribute
    path) are stripped; a missing key raises with the nearest keys."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    sd = _StateDict(_strip_wrapper_prefixes(sd, ("basenet.", "upconv1.", "conv_cls.")))
    p: Dict[str, Any] = {"vgg": {}, "fc": {}, "up": {}, "head": {}}
    for idx, name in zip(VGG_CONV_IDX, VGG_NAMES):
        base = f"basenet.{slice_of(idx)}.{idx}"
        p["vgg"][name] = {"conv": _conv(sd[f"{base}.weight"], sd.get(f"{base}.bias")),
                          "bn": _bn(sd, f"basenet.{slice_of(idx + 1)}.{idx + 1}")}
    p["fc"]["fc6"] = _conv(sd["basenet.slice5.1.weight"], sd.get("basenet.slice5.1.bias"))
    p["fc"]["fc7"] = _conv(sd["basenet.slice5.2.weight"], sd.get("basenet.slice5.2.bias"))
    for i in range(1, 5):
        base = f"upconv{i}.conv"
        p["up"][f"upconv{i}"] = {
            "conv1": _conv(sd[f"{base}.0.weight"], sd.get(f"{base}.0.bias")),
            "bn1": _bn(sd, f"{base}.1"),
            "conv2": _conv(sd[f"{base}.3.weight"], sd.get(f"{base}.3.bias")),
            "bn2": _bn(sd, f"{base}.4"),
        }
    for j, idx in enumerate(HEAD_IDX, start=1):
        p["head"][f"conv{j}"] = _conv(sd[f"conv_cls.{idx}.weight"],
                                      sd.get(f"conv_cls.{idx}.bias"))
    return p


def _split_qkv(w, b, dim: int):
    """A fused [3D, D] qkv / in_proj -> separate q/k/v linear leaves."""
    w = np.asarray(w, np.float32)
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        p = {"w": w[i * dim:(i + 1) * dim].T}
        if b is not None:
            p["b"] = np.asarray(b, np.float32)[i * dim:(i + 1) * dim]
        out[name] = p
    return out


def convert_parseq_state_dict(sd: Dict[str, Any], cfg: ParseqConfig = ParseqConfig()):
    """baudm-PARSEQ state dict -> the PARSEQ tree. Wrapper prefixes
    (Lightning's 'model.', a tracing wrapper's attribute path) are
    stripped; a missing key raises with the nearest keys."""
    sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items()}
    sd = _StateDict(_strip_wrapper_prefixes(sd, ("encoder.", "decoder.", "text_embed.")))
    D = cfg.embed_dim
    ph, pw = cfg.patch_size
    pe_w = np.asarray(sd["encoder.patch_embed.proj.weight"], np.float32)  # [D, 3, ph, pw]
    p: Dict[str, Any] = {
        "patch_embed": {"w": np.transpose(pe_w, (2, 3, 1, 0)).reshape(ph * pw * 3, D),
                        "b": np.asarray(sd["encoder.patch_embed.proj.bias"], np.float32)},
        "pos_embed": np.asarray(sd["encoder.pos_embed"], np.float32),
        "enc": [],
        "enc_norm": _ln(sd, "encoder.norm"),
        "text_embed": np.asarray(sd["text_embed.embedding.weight"], np.float32),
        "pos_queries": np.asarray(sd["pos_queries"], np.float32),
        "dec": [],
        "dec_norm": _ln(sd, "decoder.norm"),
        "head": _linear(sd, "head"),
    }
    for i in range(cfg.enc_depth):
        b = f"encoder.blocks.{i}"
        attn = _split_qkv(sd[f"{b}.attn.qkv.weight"], sd.get(f"{b}.attn.qkv.bias"), D)
        attn["o"] = _linear(sd, f"{b}.attn.proj")
        p["enc"].append({"norm1": _ln(sd, f"{b}.norm1"), "attn": attn,
                         "norm2": _ln(sd, f"{b}.norm2"),
                         "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"),
                                 "fc2": _linear(sd, f"{b}.mlp.fc2")}})
    for i in range(cfg.dec_depth):
        b = f"decoder.layers.{i}"
        sa = _split_qkv(sd[f"{b}.self_attn.in_proj_weight"],
                        sd.get(f"{b}.self_attn.in_proj_bias"), D)
        sa["o"] = _linear(sd, f"{b}.self_attn.out_proj")
        ca = _split_qkv(sd[f"{b}.cross_attn.in_proj_weight"],
                        sd.get(f"{b}.cross_attn.in_proj_bias"), D)
        ca["o"] = _linear(sd, f"{b}.cross_attn.out_proj")
        p["dec"].append({"norm_q": _ln(sd, f"{b}.norm_q"), "norm_c": _ln(sd, f"{b}.norm_c"),
                         "self_attn": sa, "norm1": _ln(sd, f"{b}.norm1"), "cross_attn": ca,
                         "norm2": _ln(sd, f"{b}.norm2"),
                         "linear1": _linear(sd, f"{b}.linear1"),
                         "linear2": _linear(sd, f"{b}.linear2")})
    return p


def _load_torch_state_dict(path: str) -> Dict[str, Any]:
    return _load_torch(path)[0]


def _load_torch(path: str):
    """A TorchScript archive or a plain torch checkpoint -> (numpy state
    dict, the executable jit module or None).

    `torch.jit.load` first (the reference's own loader), then `torch.load`
    with weights_only=True (a bare state dict or a {'model'|'state_dict':
    ...} wrapper), then weights_only=False for a pickled nn.Module (trusting
    the artifact as torch.jit.load does). Raises ValueError with both
    reasons when neither parses."""
    import torch

    try:
        m = torch.jit.load(path, map_location="cpu").eval()
        return {k: v.numpy() for k, v in m.state_dict().items()}, m
    except Exception as jit_err:  # noqa: BLE001 - try the other format
        try:
            try:
                obj = torch.load(path, map_location="cpu", weights_only=True)
            except Exception:  # noqa: BLE001 - a pickled module needs the full loader
                obj = torch.load(path, map_location="cpu", weights_only=False)
        except Exception as load_err:  # noqa: BLE001
            raise ValueError(
                f"{path!r} is neither a TorchScript archive (torch.jit.load: {jit_err}) "
                f"nor a torch checkpoint (torch.load: {load_err})") from load_err
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        for key in ("state_dict", "model"):
            if isinstance(obj, dict) and key in obj:
                inner = obj[key]
                if hasattr(inner, "state_dict") and not isinstance(inner, dict):
                    obj = inner.state_dict()
                elif isinstance(inner, dict):
                    obj = inner
        if not isinstance(obj, dict):
            raise ValueError(f"{path!r}: torch.load returned {type(obj).__name__}, "
                             f"expected a state dict (or a checkpoint wrapping one)")
        return {k: v.numpy() for k, v in obj.items() if hasattr(v, "numpy")}, None


# ---------------------------------------------------------------------------
# The input-normalization probe
# ---------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

NORM_CANDIDATES = {
    "identity": ((), ()),
    # upstream PARSEQ's transform, 2x - 1: mean 0.5, std 0.5
    "pm1": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    # the same statistics, for a trace fed channel-swapped inputs
    "imagenet_bgr": (IMAGENET_MEAN[::-1], IMAGENET_STD[::-1]),
}


def _port_forward(model: str, params, cfg, device):
    """The port's fp32 forward of a converted tree on `device`: x [N, H, W,
    3] numpy -> numpy output (CRAFT's scores; PARSEQ's logits with every
    decode step computed, no early exit)."""
    import torch

    from tuatara_tpu_torch.models.layers import set_compute_dtype
    from tuatara_tpu_torch.weights import craft_state_dict, parseq_state_dict

    if model == "craft":
        from tuatara_tpu_torch.models.craft import Craft

        net = Craft(cfg)
        net.load_state_dict(craft_state_dict(params, cfg.bn_eps))
    else:
        from tuatara_tpu_torch.models.parseq import Parseq

        net = Parseq(cfg)
        net.load_state_dict(parseq_state_dict(params))
    net.eval().requires_grad_(False)
    set_compute_dtype(net, torch.float32)
    net.to(device)

    def forward(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            out = net(xt)[0] if model == "craft" else net(xt, early_exit=False)
            return out.float().cpu().numpy()

    return forward


def probe_input_normalization(module, params, model: str, cfg, rtol: float = 2e-2,
                              atol: float = 2e-2, device: Optional[str] = None) -> str:
    """Which input transform makes the port's forward of the converted
    weights match the traced module? -> a name of NORM_CANDIDATES, or
    "unknown" (no candidate within tolerance, or an output of another
    shape).

    `module`: an executable torch.jit module, run on the CPU on a fixed [0,
    1] input (CRAFT [1, 3, 64, 96], PARSEQ [2, 3, 32, 128]); `model`:
    "craft" | "parseq". The port's forward runs at fp32 on `device` (None:
    the card), TF32 off. Every candidate is scored; the best within
    `atol + rtol * max|want|` wins, and identity wins a tie within 2x
    (serving must not add a transform the evidence cannot tell from
    none)."""
    import torch

    from tuatara_tpu_torch.api import resolve_device

    rng = np.random.default_rng(0)
    if model == "craft":
        x = rng.random((1, 64, 96, 3)).astype(np.float32)
    elif model == "parseq":
        x = rng.random((2, 32, 128, 3)).astype(np.float32)
    else:
        raise ValueError(f"model must be 'craft' or 'parseq', got {model!r}")
    dev = resolve_device(device)

    with torch.no_grad():
        out = module(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    if isinstance(out, (tuple, list)):
        out = out[0]  # the reference reads element 0
    want = np.asarray(out.float())
    if model == "craft" and want.ndim == 4 and want.shape[1] == 2 and want.shape[-1] != 2:
        want = want.transpose(0, 2, 3, 1)  # an NCHW head -> the NHWC contract

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        forward = _port_forward(model, params, cfg, dev)
        scale = float(np.max(np.abs(want))) or 1.0
        errs = {}
        for name, (mean, std) in NORM_CANDIDATES.items():
            xin = x if not mean else (x - np.float32(mean)) / np.float32(std)
            got = forward(xin)
            if got.shape != want.shape:
                return "unknown"  # another architecture; no transform fixes it
            errs[name] = float(np.max(np.abs(got - want)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    best = min(errs, key=errs.get)
    if errs[best] > atol + rtol * scale:
        return "unknown"
    if best != "identity" and errs["identity"] <= 2.0 * errs[best]:
        return "identity"
    return best


def convert_torchscript_weights(reference_weights_dir: str, out_weights_dir: str,
                                craft_cfg: CraftConfig = CraftConfig(),
                                parseq_cfg: ParseqConfig = ParseqConfig(),
                                probe_normalization: bool = True,
                                device: Optional[str] = None) -> Dict[str, str]:
    """Convert the reference's weights directory (the two TorchScript
    artifacts under their reference names; plain torch checkpoints under
    those names are read too) into the engine's npz directory, configs
    included.

    For an executable traced module the normalization probe runs (on
    `device`, None: the card) and a transform found is baked into the
    saved config. -> {"craft": verdict, "parseq": verdict}: a candidate
    name, "skipped" for a checkpoint with no graph, or "unknown", which is
    logged as a warning: such weights need a look before they are served."""
    from tuatara_tpu_torch.utils.weights import save_weights_dir

    logger = logging.getLogger("tuatara_tpu_torch.convert")
    specs = {"craft": (CRAFT_ARTIFACT, craft_cfg, convert_craft_state_dict),
             "parseq": (PARSEQ_ARTIFACT, parseq_cfg, convert_parseq_state_dict)}
    results: Dict[str, str] = {}
    params, cfgs = {}, {}
    for model, (fname, cfg, convert_fn) in specs.items():
        sd, module = _load_torch(os.path.join(reference_weights_dir, fname))
        params[model] = convert_fn(sd, cfg)
        verdict = "skipped"
        if probe_normalization and module is not None:
            verdict = probe_input_normalization(module, params[model], model, cfg,
                                                device=device)
            if verdict == "unknown":
                logger.warning("%s: the traced output matches no known input transform "
                               "(identity/pm1/imagenet); do not serve before investigating",
                               model)
            elif verdict != "identity":
                mean, std = NORM_CANDIDATES[verdict]
                cfg = dataclasses.replace(cfg, input_mean=mean, input_std=std)
                logger.warning("%s: the traced artifact normalizes internally (%s); baked "
                               "into the saved config's input_mean/input_std", model, verdict)
        cfgs[model] = cfg
        results[model] = verdict
    save_weights_dir(out_weights_dir, params["craft"], params["parseq"],
                     craft_config=cfgs["craft"], parseq_config=cfgs["parseq"])
    return results
