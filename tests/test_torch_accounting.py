"""The port's accounting against the JAX package's and against the figures
its chip runs printed, on the CPU: ``count_flops_params``, ``model_flops``
and ``param_bytes`` equal to JAX's as integers for every zoo config at
full size; each kernel's ``cost.work`` / ``cost.bwd_work`` at the shapes
PERF.md's kernel tables give; the H100's figures and ``launch.mesh.bound``;
the local mesh over a process group."""
import functools

import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_arch
from repro.models import registry as JR
from repro_torch.configs import ARCH_IDS as TORCH_ARCH_IDS
from repro_torch.configs import get_arch as torch_arch
from repro_torch.kernels.flash_attention import cost as fa_cost
from repro_torch.kernels.mlstm_scan import cost as ml_cost
from repro_torch.kernels.moe_gmm import cost as gmm_cost
from repro_torch.kernels.rglru_scan import cost as rg_cost
from repro_torch.launch import mesh
from repro_torch.models import registry as R

BF16, F32 = torch.bfloat16, torch.float32


def test_the_port_knows_every_zoo_config():
    assert sorted(TORCH_ARCH_IDS) == sorted(ARCH_IDS)


@pytest.fixture
def jax_shapes_once(monkeypatch):
    """The JAX package's init shapes traced once per config: its counts
    each trace them anew, and a full-size trace takes seconds."""
    monkeypatch.setattr(JR, "params_and_axes_shapes",
                        functools.lru_cache()(JR.params_and_axes_shapes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch, jax_shapes_once):
    tc, jc = torch_arch(arch), jax_arch(arch)
    for active in (True, False):
        got = R.count_flops_params(tc, active_only=active)
        assert isinstance(got, int)
        assert got == JR.count_flops_params(jc, active_only=active)
    for train in (True, False):
        assert R.model_flops(tc, 8192, train=train) == \
            JR.model_flops(jc, 8192, train=train)
    for dtype_bytes in (2, 4):
        assert R.param_bytes(tc, dtype_bytes) == \
            JR.param_bytes(jc, dtype_bytes)


@pytest.mark.parametrize("arch,n", [("minicpm-2b", 2_724_880_896),
                                    ("mixtral-8x7b", 12_748_853_248)])
def test_model_flops_known_values(arch, n):
    cfg = torch_arch(arch)
    assert R.count_flops_params(cfg) == n
    # 6 N D for a train step of 8192 tokens, 2 N D for inference
    assert R.model_flops(cfg, 8192) == 6.0 * n * 8192
    assert R.model_flops(cfg, 8192, train=False) == 2.0 * n * 8192


def test_untied_lookup_and_experts_left_out():
    # minicpm-2b ties its head: every parameter takes part in a product
    cfg = torch_arch("minicpm-2b")
    assert R.count_flops_params(cfg) == R.count_params_analytic(cfg)
    # minitron-8b's untied embedding is a lookup
    cfg = torch_arch("minitron-8b")
    assert R.count_params_analytic(cfg) - R.count_flops_params(cfg) == \
        cfg.vocab_size * cfg.d_model
    # mixtral's experts count top_k / E of their weights
    cfg = torch_arch("mixtral-8x7b")
    assert R.count_flops_params(cfg, active_only=False) - \
        R.count_flops_params(cfg) == cfg.n_layers * 3 * cfg.d_model * \
        cfg.d_ff * (cfg.n_experts - cfg.top_k)


# (work, dtype, GFLOP, MB) as PERF.md's kernel tables print them: flash at
# minicpm-2b's prefill (B 4, S 1000, 36 x 64), llama-vision's, hubert's
# train shape, deepseek's and h2o's past its window; its backward at B 1,
# S 4096, 36 x 64 and hubert's; moe_gmm at granite's prefill (every row
# live) and its routed-decode bound's bytes; rglru fused and whole gates at
# recurrentgemma's prefill and the fused route at its train shape, the
# backward there; mlstm at xlstm-1.3b's prefill and its backward at the
# train shape
WORK_CASES = [
    ("flash minicpm prefill", fa_cost.work(4, 1000, 36, 36, 64, True, 0,
                                           BF16), 18.45, 73.73),
    ("flash llama-vision", fa_cost.work(4, 1000, 32, 8, 128, True, 0, BF16),
     32.80, None),
    ("flash hubert train", fa_cost.work(1, 4096, 16, 16, 80, False, 0,
                                        BF16), 85.90, None),
    ("flash deepseek", fa_cost.work(4, 1000, 56, 8, 128, True, 0, BF16),
     57.40, None),
    ("flash h2o window", fa_cost.work(4, 5000, 32, 8, 120, True, 4096,
                                      BF16), 743.02, None),
    ("flash bwd minicpm train", fa_cost.bwd_work(1, 4096, 36, 36, 64, True,
                                                 0, BF16), 193.32, 151.58),
    ("flash bwd hubert", fa_cost.bwd_work(1, 4096, 16, 16, 80, False, 0,
                                          BF16), 214.75, None),
    ("moe_gmm granite prefill", gmm_cost.work(40, 1000, 1536, 512, True,
                                              BF16), 188.74, None),
    ("moe_gmm bwd granite train", gmm_cost.bwd_work(32768, 40, 1536, 512,
                                                    True, BF16),
     309.24, 679.48),
    ("rglru fused", rg_cost.work(4, 1000, 4096, BF16, BF16, False, True),
     None, 163.95),
    ("rglru gates", rg_cost.work(4, 1000, 4096, BF16, F32, False, False),
     None, 229.46),
    ("rglru train", rg_cost.work(1, 4096, 4096, BF16, BF16, False, True),
     None, 167.84),
    ("rglru bwd train", rg_cost.bwd_work(1, 4096, 4096, BF16, True),
     0.587, 335.61),
    ("mlstm prefill", ml_cost.work(4, 1000, 4, 1024, BF16, False),
     67.17, 231.14),
    ("mlstm bwd train", ml_cost.bwd_work(1, 4096, 4, 1024, BF16),
     177.25, 335.94),
]


@pytest.mark.parametrize("name,work,gflop,mb", WORK_CASES,
                         ids=[c[0] for c in WORK_CASES])
def test_kernel_work_gives_perf_tables_figures(name, work, gflop, mb):
    flops, nbytes = work
    if gflop is not None:
        assert f"{flops / 1e9:.{2 if gflop >= 1 else 3}f}" == \
            f"{gflop:.{2 if gflop >= 1 else 3}f}"
    if mb is not None:
        assert f"{nbytes / 1e6:.2f}" == f"{mb:.2f}"


@pytest.mark.parametrize("work,dtype,ms,by", [
    # flash at minicpm's prefill: 0.0220 ms by bytes; granite's: 0.0124 ms
    # by operations; the backward at minicpm's train shape: 0.1955 ms
    (fa_cost.work(4, 1000, 36, 36, 64, True, 0, BF16), BF16, "0.0220",
     "bytes"),
    (fa_cost.work(4, 1000, 24, 8, 64, True, 0, BF16), BF16, "0.0124",
     "operations"),
    (fa_cost.bwd_work(1, 4096, 36, 36, 64, True, 0, BF16), BF16, "0.1955",
     "operations"),
    # mlstm at the serving shape: 69.00 us by bytes; rglru fused 0.0489 ms
    (ml_cost.work(4, 1000, 4, 1024, BF16, False), BF16, "0.0690", "bytes"),
    (rg_cost.work(4, 1000, 4096, BF16, BF16, False, True), F32, "0.0489",
     "bytes"),
])
def test_bound_gives_perf_tables_times(work, dtype, ms, by):
    got_ms, got_by, flops, nbytes = mesh.bound(work, dtype)
    assert (f"{got_ms:.4f}", got_by) == (ms, by)
    assert (flops, nbytes) == work


def test_moe_gmm_work_scales_with_rows_and_gate():
    f1, b1 = gmm_cost.work(8, 16, 64, 32, True, BF16)
    f2, b2 = gmm_cost.work(8, 32, 64, 32, True, BF16)
    assert f2 == 2 * f1 and b2 > b1
    # without a gate: two products instead of three
    assert gmm_cost.work(8, 16, 64, 32, False, BF16)[0] == f1 * 2 / 3
    assert gmm_cost.bwd_work(128, 8, 64, 32, False, BF16)[0] == \
        gmm_cost.bwd_work(128, 8, 64, 32, True, BF16)[0] * 2 / 3


def test_flash_pairs_follow_the_mask():
    assert fa_cost.visible_pairs(5, True, 0) == 15
    assert fa_cost.visible_pairs(5, False, 0) == 25
    assert fa_cost.visible_pairs(5, True, 2) == 9
    assert fa_cost.visible_pairs(1, True, 0) == 1


def test_h100_figures():
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.PEAK_FLOPS_F32 == 67e12
    assert mesh.HBM_BW == 3.35e12 and mesh.HBM_BYTES == 80 * 10**9
    assert mesh.NVLINK_BW == 450e9 and mesh.SMS == 132
    assert mesh.SMEM_PER_BLOCK == 232_448
    assert mesh.PEAK_FLOPS[BF16] == mesh.PEAK_FLOPS_BF16
    assert mesh.PEAK_FLOPS[F32] == mesh.PEAK_FLOPS_F32


def test_local_mesh_needs_a_process_group(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_local_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        m = mesh.make_local_mesh()
        assert mesh.mesh_chips(m) == 1
        assert m.mesh_dim_names == ("data", "model")
        assert m["data"].mesh_dim_names == ("data",)
    finally:
        dist.destroy_process_group()
