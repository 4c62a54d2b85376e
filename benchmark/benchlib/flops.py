"""Operation counts from shapes, and the peaks they are held against.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W
limit: 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32 outside the
tensor cores, 3.35 TB/s HBM3.

An operation is a multiply or an add: a multiply-accumulate is 2. The
counts are of the work the served algorithm needs for the pages and crops
given, never of padding: CRAFT over each page's canvas, the decoder's
trunk-side 1x1 conv at the trunk's resolution and its output upsampled
(the order the port's 16-bit and int8 paths take); PARSEQ over the live
crops, each decoded for as many steps as its served text (and its EOS)
needs. The encoder block count and the greedy step count are frozen
copies of `chip_smoke.py`'s K6 operation count (phase 4b) and
`decode_ops` (K7, with the content K/V read from its per-(token,
position) tables) at commit d849d6a.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

CRAFT_STAGE_CONVS = (2, 2, 3, 3, 2)


def craft_convs(h: int, w: int, arch: Dict) -> List[Tuple[str, int, int, int, int, int]]:
    """CRAFT's convolutions on an [h, w] canvas (h, w multiples of 32) ->
    [(path, out_h, out_w, cin, cout, k)]."""
    s = arch["stage_channels"]
    out = []
    cin, rh, rw = 3, h, w
    for st, (n, cout) in enumerate(zip(CRAFT_STAGE_CONVS, s)):
        if st:
            rh, rw = rh // 2, rw // 2
        for i in range(n):
            out.append((f"vgg/conv{st + 1}_{i + 1}/conv", rh, rw, cin, cout, 3))
            cin = cout
    fc = arch["fc_channels"]
    out += [("fc/fc6", rh, rw, s[4], fc, 3), ("fc/fc7", rh, rw, fc, fc, 1)]
    skips = [(h // 16, w // 16, s[4]), (h // 8, w // 8, s[3]), (h // 4, w // 4, s[2]),
             (h // 2, w // 2, s[1])]
    tch, th, tw = fc, h // 16, w // 16
    for lvl, ((mid, cout), (sh, sw, sch)) in enumerate(zip(arch["up_channels"], skips), 1):
        b = f"up/upconv{lvl}"
        out += [(f"{b}/conv1a", th, tw, tch, mid, 1), (f"{b}/conv1b", sh, sw, sch, mid, 1),
                (f"{b}/conv2", sh, sw, mid, cout, 3)]
        tch, th, tw = cout, sh, sw
    hc = arch["head_channels"]
    chans = [tch, hc[0], hc[1], hc[2], hc[3], arch["num_classes"]]
    for i, k in enumerate((3, 3, 3, 1, 1)):
        out.append((f"head/conv{i + 1}", th, tw, chans[i], chans[i + 1], k))
    return out


def conv_ops(c) -> int:
    _, oh, ow, cin, cout, k = c
    return 2 * oh * ow * cin * cout * k * k


def precision_of(path: str, precision: Dict[str, str]) -> str:
    return precision.get(path, precision["default"])


def craft_least_s(h: int, w: int, arch: Dict, precision: Dict[str, str]) -> float:
    """The least time of one page's CRAFT at peak: each conv's operations
    at the peak of its stated precision, or its weights, canvas and score
    bytes at the HBM rate when that is longer."""
    convs = craft_convs(h, w, arch)
    t_ops = sum(conv_ops(c) / PEAK_OPS[precision_of(c[0], precision)] for c in convs)
    w_bytes = sum(c[3] * c[4] * c[5] * c[5] * (1 if precision_of(c[0], precision) == "int8"
                                               else 2) for c in convs)
    io = h * w * 3 * 4 + (h // 2) * (w // 2) * 2 * 4
    return max(t_ops, (w_bytes + io) / HBM_BYTES_PER_S)


def k6_ops(arch: Dict) -> int:
    """The encoder blocks on one crop, what K6 computes (`chip_smoke.py`
    phase 4b's count: 2 * (S * D * (3D + D + 2 * hidden) + 2 * S * S * D) a
    block)."""
    d = arch["embed_dim"]
    hid = int(d * arch["enc_mlp_ratio"])
    ph, pw = arch["patch_size"]
    s = (arch["img_size"][0] // ph) * (arch["img_size"][1] // pw)
    return arch["enc_depth"] * 2 * (s * d * (3 * d + d + 2 * hid) + 2 * s * s * d)


def encoder_ops(arch: Dict) -> int:
    """PARSeq's encoder on one crop: the patch embedding and the blocks."""
    ph, pw = arch["patch_size"]
    s = (arch["img_size"][0] // ph) * (arch["img_size"][1] // pw)
    return 2 * s * ph * pw * 3 * arch["embed_dim"] + k6_ops(arch)


def decode_ops(arch: Dict, steps: int) -> int:
    """One crop's greedy decode of `steps` steps (`chip_smoke.decode_ops`
    per step), the memory's cross-attention K/V, and one cloze pass over
    all T positions."""
    d = arch["embed_dim"]
    hid = int(d * arch["dec_mlp_ratio"])
    c = arch["charset_size"] + 1
    ph, pw = arch["patch_size"]
    s = (arch["img_size"][0] // ph) * (arch["img_size"][1] // pw)
    t = arch["max_label_length"] + 1
    greedy = sum(2 * (3 * d * d + 2 * d * hid + d * c) + 4 * (i + 1) * d + 4 * s * d
                 for i in range(steps))
    mem_kv = 2 * 2 * s * d * d
    cloze = (2 * t * d * d * 6 + 2 * 2 * t * t * d + 2 * 2 * t * s * d + 2 * 2 * t * d * hid
             + 2 * t * d * c)
    return greedy + mem_kv + cloze


def crop_ops(arch: Dict, text_len: int) -> int:
    """Encoder and decode of one live crop whose served text has
    `text_len` characters (its EOS one more step, T at most)."""
    t = arch["max_label_length"] + 1
    return encoder_ops(arch) + decode_ops(arch, min(text_len + 1, t))
