"""The FLOP and byte arithmetic against counts worked out by hand from the
published widths (8×256 trunk with its skip at layer 4, 63-wide point
encoding; the GAN's 334- and 272-wide heads; the pretrain's 259-wide
head)."""

import os

import pytest

from bench_port.lib import flops, harness


def cfg_of(cell):
    from texpose_tpu_torch.utils.config import load_yaml
    spec = harness.cell_spec(cell)
    return load_yaml(os.path.join(harness.ROOT,
                                  spec["config"]["yaml"])).to_dict()


TRUNK = 2 * (63 * 256 + 6 * 256 * 256 + 319 * 256) + 2 * 256     # 982,528
RGB_GAN = 2 * (334 * 256 + 2 * 256 * 256 + 256 * 3)
TRANS = 2 * (272 * 256 + 2 * 256 * 256 + 256 * 5)
RGB_PRE = 2 * (259 * 256 + 2 * 256 * 256 + 256 * 3)


def test_trunk_forward():
    assert TRUNK == 982_528
    assert flops.trunk_forward_flops(cfg_of("gan.train")) == TRUNK


def test_gan_step():
    cfg = cfg_of("gan.train")
    rows = 8 * 16 * 16 * 64
    # heads: forward + weight gradient + input gradient of every layer but
    # the first, whose input gradient reaches the latents only (48 / 16)
    rgb_dx = RGB_GAN - 2 * 334 * 256 + 2 * 48 * 256
    tr_dx = TRANS - 2 * 272 * 256 + 2 * 16 * 256
    want = rows * (TRUNK + 2 * RGB_GAN + rgb_dx + 2 * TRANS + tr_dx)
    f, b = flops.field_work(cfg, {"kind": "gan_step", "B": 8, "p": 16,
                                  "N": 64})
    assert f == want
    assert f / rows == pytest.approx(3.221e6, rel=1e-3)
    vgg = 2 * 9 * (16 * 16 * (3 * 64 + 64 * 64) + 8 * 8 * (64 * 128
                   + 128 * 128) + 4 * 4 * (128 * 256 + 2 * 256 * 256))
    assert flops.vgg_forward_flops(16) == vgg
    disc = 2 * (16 * 9 * 256 * 64 + 16 * 256 * 512 * 16 + 16 * 512 * 64
                + 73 * 64 + 64 * 64 + 64)
    assert flops.disc_forward_flops(cfg) == disc
    m = flops.model_flops(cfg, {"kind": "gan_step", "B": 8, "p": 16,
                                "N": 64})
    assert m == want + 6 * 8 * vgg + 12 * 8 * disc
    assert m / 1e9 == pytest.approx(433.75, rel=1e-3)


def test_pretrain_step_and_frame():
    cfg = cfg_of("pretrain.train")
    rows = 2048 * 64
    assert RGB_PRE + TRUNK == 1_378_816          # ≈ 1.377 MFLOP a row
    dx = TRUNK - 2 * 63 * 256 + RGB_PRE
    want = rows * (2 * (TRUNK + RGB_PRE) + dx)
    f, _ = flops.field_work(cfg, {"kind": "pretrain_step", "rays": 2048,
                                  "N": 64})
    assert f == want
    assert f / 1e9 == pytest.approx(537.94, rel=1e-4)
    assert flops.model_flops(cfg, {"kind": "pretrain_step", "rays": 2048,
                                   "N": 64}) == f
    f, b = flops.field_work(cfg, {"kind": "pretrain_frame", "H": 480,
                                  "W": 480, "N": 64})
    assert f == 480 * 480 * 64 * (TRUNK + RGB_PRE)
    assert f / 1e12 == pytest.approx(20.33, rel=1e-3)
    # flop-bound at the bf16 peak
    assert flops.least_seconds(f, b) == f / flops.PEAK_FLOPS


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert flops.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)
