"""Operation counts against hand counts at small shapes."""

import pytest

from benchlib import flops

ARCH = {"stage_channels": [2, 4, 4, 8, 8], "fc_channels": 16,
        "up_channels": [[8, 4], [4, 4], [4, 2], [2, 2]], "head_channels": [2, 2, 2, 2],
        "num_classes": 2}


def test_craft_convs_by_hand():
    convs = {c[0]: c for c in flops.craft_convs(64, 32, ARCH)}
    assert len(convs) == 12 + 2 + 12 + 5
    assert flops.conv_ops(convs["vgg/conv1_1/conv"]) == 2 * 64 * 32 * 3 * 2 * 9
    assert flops.conv_ops(convs["vgg/conv5_2/conv"]) == 2 * 4 * 2 * 8 * 8 * 9
    assert flops.conv_ops(convs["fc/fc6"]) == 2 * 4 * 2 * 8 * 16 * 9
    # upconv2: the trunk side at the trunk's resolution (H / 16), the skip
    # side and conv2 at the skip's (H / 8)
    assert flops.conv_ops(convs["up/upconv2/conv1a"]) == 2 * 4 * 2 * 4 * 4
    assert flops.conv_ops(convs["up/upconv2/conv1b"]) == 2 * 8 * 4 * 8 * 4
    assert flops.conv_ops(convs["up/upconv2/conv2"]) == 2 * 8 * 4 * 4 * 4 * 9
    assert flops.conv_ops(convs["head/conv5"]) == 2 * 32 * 16 * 2 * 2


def test_craft_least_time_takes_each_precision():
    convs = flops.craft_convs(64, 32, ARCH)
    ops = sum(flops.conv_ops(c) for c in convs)
    bf16 = flops.craft_least_s(64, 32, ARCH, {"default": "bf16"})
    int8 = flops.craft_least_s(64, 32, ARCH, {"default": "int8", "head/conv5": "bf16"})
    # at these sizes the bytes bound: both at least their ops at peak
    assert bf16 >= ops / 989e12 and int8 >= ops / 1979e12


def test_full_width_craft_at_1024x768():
    real = {"stage_channels": [64, 128, 256, 512, 512], "fc_channels": 1024,
            "up_channels": [[512, 256], [256, 128], [128, 64], [64, 32]],
            "head_channels": [32, 32, 16, 16], "num_classes": 2}
    ops = sum(flops.conv_ops(c) for c in flops.craft_convs(1024, 768, real))
    assert ops == pytest.approx(555.875e9, rel=1e-5)
    t = flops.craft_least_s(1024, 768, real, {"default": "bf16"})
    assert t == pytest.approx(ops / 989e12)


PARSEQ = {"embed_dim": 8, "enc_mlp_ratio": 2.0, "dec_mlp_ratio": 2.0, "patch_size": [2, 2],
          "img_size": [4, 8], "enc_depth": 2, "charset_size": 3, "max_label_length": 3}


def test_parseq_counts_by_hand():
    d, hid, s, t, c = 8, 16, 8, 4, 4
    block = 2 * (s * d * (4 * d + 2 * hid) + 2 * s * s * d)
    assert flops.k6_ops(PARSEQ) == 2 * block
    assert flops.encoder_ops(PARSEQ) == 2 * s * 12 * d + 2 * block
    step = lambda i: 2 * (3 * d * d + 2 * d * hid + d * c) + 4 * (i + 1) * d + 4 * s * d
    cloze = (12 * t * d * d + 4 * t * t * d + 4 * t * s * d + 4 * t * d * hid + 2 * t * d * c)
    assert flops.decode_ops(PARSEQ, 2) == step(0) + step(1) + 4 * s * d * d + cloze
    assert flops.crop_ops(PARSEQ, 9) == flops.encoder_ops(PARSEQ) + flops.decode_ops(PARSEQ, 4)
