"""Configuration for the PyTorch port of the tuatara OCR engine.

Own copy of `tuatara_tpu/config.py`: the same fields with the same defaults,
so one configuration reads the same in both packages. Every constant the
reference hardcodes lives here, defaulting to the reference values because
they are parity-critical (reference: tuatara.cpp:352-353 canvas size / mag
ratio, tuatara.cpp:397-399 thresholds, tuatara.cpp:440 crop size,
tuatara.cpp:148 min component area, tuatara.cpp:166 dilation formula).

Lowering fields keep the JAX value strings, so one configuration and the
stored `config.json` read the same in both packages: `encoder_impl="pallas"`
and `decode_impl="pallas"` select the port's counterparts of those Pallas
kernels (the hand-written CUDA kernels K6 `kernels/vit.py` and K7
`kernels/decode.py`), "xla" or None the plain PyTorch lowering. The port
refuses any other value. `OcrConfig.latency()` and `OcrConfig.production()`
are carried over; `quantized_serving` quantizes the detector (CRAFT) to
int8, and the recognizer's encoder too unless `encoder_impl="pallas"`.
`decode_mode` takes "greedy", "beam" (`beam_size` beams) or "nar".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class OcrConfig:
    """Frozen, hashable engine configuration (reference defaults)."""

    # ---- Detection preprocessing (tuatara.cpp:352-353, 206-234) ----
    canvas_size: int = 1024        # long-side cap for the detection canvas
    mag_ratio: float = 1.0         # magnification before capping
    size_multiple: int = 32        # pad H/W up to a multiple of this
    # Canvas dims round up to this bucket (0 = always the full square).
    # Outputs do not depend on it: everything beyond the content extent is
    # masked out of box extraction.
    canvas_bucket: int = 256
    # Tiled detection of pages larger than the canvas (not ported yet).
    tiled_detection: bool = False
    tile_overlap: int = 256

    # ---- Detection post-processing thresholds (tuatara.cpp:397-399) ----
    text_threshold: float = 0.7    # min peak region score to keep a component
    link_threshold: float = 0.4    # affinity binarization threshold
    low_text: float = 0.4          # region binarization threshold
    min_component_area: int = 10   # drop components smaller than this (tuatara.cpp:148)

    # CRAFT emits heatmaps at half the canvas resolution (tuatara.cpp:236-253).
    ratio_net: int = 2

    # ---- Fixed budgets ----
    max_boxes: int = 256           # box budget per page; extras dropped
    cc_max_iters: int = 64         # sweep cap of the JAX labeler (unused here:
                                   # union-find always converges)

    # ---- Recognition (tuatara.cpp:440 crop 128x32) ----
    rec_height: int = 32
    rec_width: int = 128
    max_label_length: int = 25     # PARSEQ decode budget (26 steps incl. EOS)
    # "greedy": AR argmax + cloze refinement; "nar": one non-autoregressive
    # pass + refinement; "beam": beam search (beam_size beams), no refinement.
    decode_mode: str = "greedy"
    beam_size: int = 4
    encoder_impl: Optional[str] = None
    decode_impl: Optional[str] = None

    # ---- Recognition charset ----
    # Default: the standard 94-char PARSEQ charset; `reference_charset=True`
    # selects the reference's bug-compatible 95-char table (tuatara.cpp:32-34).
    reference_charset: bool = False
    # Explicit character table; None = the charset stored next to the
    # weights, else the `reference_charset` choice.
    charset: "str | None" = None

    # ---- Box fitting ----
    # "axis": axis-aligned min/max bbox (tuatara.cpp:256-274), the only mode
    # ported so far.
    box_mode: str = "axis"
    rotated_fit: str = "exact"

    # Integer semantics of the dilation radius `int(sqrt(size * min(w,h) /
    # (w*h) * 2))` with C++ integer division (tuatara.cpp:166); "upstream"
    # is the CRAFT repo's float formula.
    niter_mode: str = "reference"

    use_pallas: str = "auto"

    # ---- Compute ----
    # Model compute dtype; heatmap post-processing always runs in fp32.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    quantized_serving: bool = False

    # ---- Batching ----
    page_batch: int = 1
    # Recognition slabs are padded to the smallest bucket >= the live box
    # count (bounded set of slab shapes).
    rec_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    # Oversized slabs (live boxes > max_boxes) round up to a multiple of
    # this; None = max_boxes.
    rec_slab_multiple: Optional[int] = None

    # Order recognition-slab rows by box aspect ratio; a pure permutation,
    # undone before results are decoded (outputs are identical).
    rec_sort_by_width: bool = True

    # ---- Channel-order parity (SURVEY.md quirk 1) ----
    # "python": CRAFT sees BGR, PARSEQ sees RGB  (parity default)
    # "cpp":    CRAFT sees RGB, PARSEQ sees BGR
    # "rgb":    both models see RGB
    channel_mode: str = "python"

    @classmethod
    def latency(cls, **overrides) -> "OcrConfig":
        """Batch-1 single-image serving preset (the JAX package's
        `OcrConfig.latency()`): the detect canvas fitted to the page's /32
        geometry, a finer first recognition bucket, and the fused
        recognizer kernels. Unlike the JAX preset it does not read a
        backend: the kernel wrappers launch on CUDA tensors and take their
        plain versions on CPU ones. Keyword overrides win."""
        base = dict(canvas_bucket=32, rec_buckets=(16, 32, 64, 128, 256),
                    encoder_impl="pallas", decode_impl="pallas", page_batch=1)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def production(cls, **overrides) -> "OcrConfig":
        """Dense-serving preset (the JAX package's `OcrConfig.production()`):
        the int8 detector (`quantized_serving`; calibrate once with
        `OcrEngine.calibrate(pages)` or ship a `calibration.npz` beside the
        weights, else each int8 conv takes its input's abs-max on every
        call), the fused recognizer kernels K6 and K7, the /32 canvas and
        slabs of 64. Like `latency()` it reads no backend. Keyword
        overrides win."""
        base = dict(quantized_serving=True, canvas_bucket=32, rec_slab_multiple=64,
                    encoder_impl="pallas", decode_impl="pallas")
        base.update(overrides)
        return cls(**base)

    @property
    def heatmap_size(self) -> Tuple[int, int]:
        s = self.canvas_size // self.ratio_net
        return (s, s)

    @property
    def num_decode_steps(self) -> int:
        return self.max_label_length + 1  # + EOS


DEFAULT_CONFIG = OcrConfig()


@dataclasses.dataclass(frozen=True)
class CraftConfig:
    """CRAFT detector architecture: VGG16-BN backbone, U-Net skip decoder,
    2-channel head at half input resolution."""

    stage_channels: Tuple[int, ...] = (64, 128, 256, 512, 512)
    fc_channels: int = 1024
    up_channels: Tuple[Tuple[int, int], ...] = (
        (512, 256), (256, 128), (128, 64), (64, 32),
    )
    head_channels: Tuple[int, ...] = (32, 32, 16, 16)
    num_classes: int = 2           # region + affinity
    bn_eps: float = 1e-5
    # Input normalization baked into the model contract: x -> (x - mean)/std
    # on the [0,1] input. Empty = identity (the reference feeds /255 only).
    input_mean: Tuple[float, ...] = ()
    input_std: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class ParseqConfig:
    """PARSEQ recognizer architecture (paper defaults): ViT-S encoder over
    the 32x128 crop + a depth-1 permutation-LM decoder."""

    img_size: Tuple[int, int] = (32, 128)
    patch_size: Tuple[int, int] = (4, 8)
    embed_dim: int = 384
    enc_depth: int = 12
    enc_heads: int = 6
    enc_mlp_ratio: float = 4.0
    dec_heads: int = 12
    dec_mlp_ratio: float = 4.0
    dec_depth: int = 1
    max_label_length: int = 25
    # 94 printable ASCII chars; the vocab adds EOS/BOS/PAD.
    charset_size: int = 94
    refine_iters: int = 1
    dropout: float = 0.1
    layer_norm_eps: float = 1e-6
    encoder_impl: str = "xla"
    decode_impl: str = "xla"
    input_mean: Tuple[float, ...] = ()
    input_std: Tuple[float, ...] = ()

    @property
    def num_tokens(self) -> int:
        # [EOS] + charset + [BOS] + [PAD]
        return self.charset_size + 3

    @property
    def seq_len(self) -> int:
        h = self.img_size[0] // self.patch_size[0]
        w = self.img_size[1] // self.patch_size[1]
        return h * w
