"""The port's training data (`tuatara_tpu_torch/utils/data.py`) and its
augmentation (`train/run.py`) against the JAX package, bit for bit.

Given the same `np.random.Generator` seed, `word_batch` (bitmap, tight and
TrueType styles, two widths), `word_pool` (TrueType, also refreshing rows in
place), `render_word_gray`, `gaussian_heatmap_targets`, `detection_batch`
and `synthetic_text_pages` (bitmap, upscaled, TrueType) return JAX's arrays
exactly, and leave the generator in the same state. The augmentation's
arithmetic (`augment_gray_u8_draws`), fed the draws JAX's
`_augment_gray_u8` makes (rebuilt here from the same `jax.random.split`s),
equals JAX's function run op by op, bit for bit. Compiled, XLA turns the
last `/ 255.0` into a product with the rounded reciprocal (an ulp off on
~15% of the values) and fuses the products of the draws into their sums,
which moves a value lying within an ulp of a rounding midpoint by one
uint8 step: 2, 1, 5, 3 of 786,432 values on seeds 2-5 (0 on seeds 0-1).
Against the compiled function every value is held within one uint8 step
and at most 2e-5 of them that far; `augment_gray_u8` keeps its contract
(fp32 RGB on the uint8 grid, new pixels for new draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuatara_tpu.tokenizer as JT
import tuatara_tpu.utils.data as JD
from torch_common import torch_threads  # noqa: F401
from tuatara_tpu.train.run import _augment_gray_u8
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.run import augment_gray_u8, augment_gray_u8_draws
from tuatara_tpu_torch.utils import data as D

FONTS = bool(JD.system_fonts())


def same(a, b):
    """Equal dicts of arrays (and lists), and equal generator states."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def both(fn_port, fn_jax, seed=3):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = fn_port(r1), fn_jax(r2)
    assert r1.bit_generator.state == r2.bit_generator.state
    return got, want


def test_system_fonts_equal():
    assert D.system_fonts() == JD.system_fonts()


@pytest.mark.parametrize("style,tight,width", [("bitmap", False, 128), ("bitmap", True, 128),
                                               ("font", False, 128), ("bitmap", True, 64)])
def test_word_batch_equals_jax(style, tight, width):
    if style == "font" and not FONTS:
        pytest.skip("no .ttf fonts installed")
    got, want = both(
        lambda r: D.word_batch(6, Tokenizer(), r, max_length=7, max_len=5, tight=tight,
                               style=style, width=width),
        lambda r: JD.word_batch(6, JT.Tokenizer(), r, max_length=7, max_len=5, tight=tight,
                                style=style, width=width))
    same(got, want)


@pytest.mark.skipif(not FONTS, reason="no .ttf fonts installed")
def test_word_pool_and_refresh_equal_jax():
    got, want = both(lambda r: D.word_pool(5, Tokenizer(), r, max_length=9, max_len=6),
                     lambda r: JD.word_pool(5, JT.Tokenizer(), r, max_length=9, max_len=6))
    same(got, want)
    got2, want2 = both(lambda r: D.word_pool(2, Tokenizer(), r, max_length=9, out=got, start=2),
                       lambda r: JD.word_pool(2, JT.Tokenizer(), r, max_length=9, out=want,
                                              start=2), seed=9)
    same(got2, want2)
    g, w = both(lambda r: D.render_word_gray("Hello1", r, width=64),
                lambda r: JD.render_word_gray("Hello1", r, width=64))
    np.testing.assert_array_equal(g, w)


def test_heat_targets_and_detection_batch_equal_jax():
    boxes, counts = [(10, 10, 40, 18), (3.5, 20.25, 30, 27)], [4, 1]
    np.testing.assert_array_equal(D.gaussian_heatmap_targets(boxes, counts, 32, 64),
                                  JD.gaussian_heatmap_targets(boxes, counts, 32, 64))
    for size, words in ((64, 3), (128, 6), (256, 4)):
        got, want = both(lambda r: D.detection_batch(2, r, size=size, words_per_page=words),
                         lambda r: JD.detection_batch(2, r, size=size, words_per_page=words))
        same(got, want)


@pytest.mark.parametrize("style,upscale", [("bitmap", 1), ("bitmap", 2), ("font", 1)])
def test_synthetic_text_pages_equal_jax(style, upscale):
    if style == "font" and not FONTS:
        pytest.skip("no .ttf fonts installed")
    got, want = both(
        lambda r: D.synthetic_text_pages(2, Tokenizer(), r, size=128, words_per_page=5,
                                         upscale=upscale, style=style),
        lambda r: JD.synthetic_text_pages(2, JT.Tokenizer(), r, size=128, words_per_page=5,
                                          upscale=upscale, style=style))
    same(got, want)


def jax_draws(key, B, H, W):
    """The draws `_augment_gray_u8` makes from `key`, as it makes them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    a = jax.random.uniform(k1, (B, 1, 1), minval=0.6, maxval=1.0)
    b = jax.random.uniform(k2, (B, 1, 1), minval=0.0, maxval=0.3)
    noise = jax.random.normal(k3, (B, H, W))
    dyx = jax.random.randint(k4, (B, 2), 0, jnp.array([5, 7]))
    return [torch.from_numpy(np.array(v)) for v in (a, b, noise, dyx)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_arithmetic_equals_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, W = 64, 32, 128
    crops = rng.integers(0, 256, (B, H, W), np.uint8)
    crops[:4] = np.array([0, 255], np.uint8)[rng.integers(0, 2, (4, H, W))]  # saturated rows
    key = jax.random.PRNGKey(seed)
    want = np.asarray(_augment_gray_u8(jnp.asarray(crops), key))
    got = augment_gray_u8_draws(torch.from_numpy(crops), *jax_draws(key, B, H, W)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, H, W, 3)
    np.testing.assert_array_equal(got, want)
    compiled = np.asarray(jax.jit(_augment_gray_u8)(jnp.asarray(crops), key))
    step = np.abs(got.astype(np.float64) - compiled)
    assert step.max() <= 1 / 255 + 1e-6
    assert (step > 1e-3).mean() <= 2e-5


def test_augment_contract():
    crops = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 128), np.uint8))
    a = augment_gray_u8(crops, torch.Generator().manual_seed(0))
    assert a.shape == (4, 32, 128, 3) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert float((a - torch.round(a * 255.0) / 255.0).abs().max()) < 1e-6
    assert torch.equal(a[..., 0], a[..., 2])
    b = augment_gray_u8(crops, torch.Generator().manual_seed(1))
    assert not torch.allclose(a, b)
    assert torch.equal(a, augment_gray_u8(crops, torch.Generator().manual_seed(0)))
