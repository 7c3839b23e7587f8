"""The frozen work counts equal hand-worked shapes."""
import json

import pytest

from conftest import BENCH


def conf(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_visible_pairs():
    from work import flash
    assert flash.visible_pairs(4, True) == 10
    assert flash.visible_pairs(4, False) == 16
    assert flash.visible_pairs(6, True, window=2) == 11


def test_flash_counts_at_the_train_shape():
    from work import flash
    pairs = 4096 * 4097 // 2
    f, b = flash.work(1, 4096, 36, 36, 64, True)
    assert f == 4.0 * 36 * 64 * pairs
    assert b == 2 * (2 * 4096 * 36 * 64 + 2 * 4096 * 36 * 64)
    f, b = flash.bwd_work(1, 4096, 24, 8, 64, True)
    assert f == 10.0 * 24 * 64 * pairs
    assert b == 2 * (4 * 4096 * 24 * 64 + 4 * 4096 * 8 * 64) + 4 * 24 * 4096


def test_least_seconds():
    from work import peaks
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_matmul_params_by_hand():
    from work import model_flops
    d, f, L, V = 2304, 5760, 40, 122753
    assert model_flops.matmul_params(conf("minicpm-2b")) == \
        L * (4 * d * d + 3 * d * f) + V * d
    d, f, L, V, H, KH = 1536, 512, 32, 49155, 24, 8
    attn = 2 * d * H * 64 + 2 * d * KH * 64
    assert model_flops.matmul_params(conf("granite-moe-3b-a800m")) == \
        L * (attn + d * 40 + 8 * 3 * d * f) + V * d


@pytest.mark.parametrize("name", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_matmul_params_are_the_ports_count_without_norms(name):
    """The port's count_flops_params counts the same matrices and the norm
    vectors (2 L d + d)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from work import model_flops
    c = conf(name)
    cfg = get_arch(c["arch"])
    norms = 2 * cfg.n_layers * cfg.d_model + cfg.d_model
    assert model_flops.matmul_params(c) == \
        registry.count_flops_params(cfg) - norms


def test_train_and_serve_flops():
    from work import flash, model_flops
    c = conf("minicpm-2b")
    n = model_flops.matmul_params(c)
    att = 40 * flash.work(1, 4096, 36, 36, 64, True)[0]
    assert model_flops.train_flops(c, 4096, 2) == \
        6.0 * n * 8192 + 3 * 2 * att
    dec = 40 * 4.0 * 36 * 64 * (100 + 1)
    assert model_flops.serve_flops(c, 100, 2) == pytest.approx(
        2.0 * n * 101 + 40 * flash.work(1, 100, 36, 36, 64, True)[0] + dec)
