"""The port's serving driver against the JAX package's, on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jax_serve
from repro.models import registry as JR
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as torch_serve


def _requests(module, vocab, lens, max_new):
    rng = np.random.default_rng(0)
    return [module.Request(i, rng.integers(1, vocab, size=n).astype(np.int32),
                           max_new=max_new) for i, n in enumerate(lens)]


def test_serve_gives_the_jax_tokens_in_float32():
    # the setup of tests/test_serve.py, in float32, with uneven prompts so
    # that left-padding and slot refill both run
    jc = dataclasses.replace(jax_arch("minicpm-2b").reduced(), dtype="float32")
    tc = dataclasses.replace(torch_arch("minicpm-2b").reduced(),
                             dtype="float32")
    lens = [16, 12, 16, 9, 16]
    want = jax_serve.serve(jc, _requests(jax_serve, jc.vocab_size, lens, 4),
                           slots=2, ctx_len=32, seed=0)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    params = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    got = torch_serve.serve(tc, _requests(torch_serve, tc.vocab_size, lens, 4),
                            slots=2, ctx_len=32, seed=0, params=params,
                            device="cpu")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 4 and r.t_done is not None for r in got)


def test_serve_without_a_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_arch("minicpm-2b").reduced()
    reqs = _requests(torch_serve, cfg.vocab_size, [8], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_serve.serve(cfg, reqs, slots=1, ctx_len=16)
    assert reqs[0].generated == []


def test_serve_is_deterministic_for_a_seed():
    cfg = torch_arch("minicpm-2b").reduced()
    a = torch_serve.serve(cfg, _requests(torch_serve, cfg.vocab_size,
                                         [8, 8, 8], 3),
                          slots=2, ctx_len=16, seed=1, device="cpu")
    b = torch_serve.serve(cfg, _requests(torch_serve, cfg.vocab_size,
                                         [8, 8, 8], 3),
                          slots=2, ctx_len=16, seed=1, device="cpu")
    assert [r.generated for r in a] == [r.generated for r in b]


def test_cli_serves_a_smoke_arch_on_the_cpu(capsys):
    done = torch_serve.main(["--arch", "minicpm-2b-smoke", "--device", "cpu",
                             "--requests", "3", "--slots", "2",
                             "--prompt-len", "8", "--gen", "3"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "arch=minicpm-2b-smoke device=cpu requests=3 new_tokens=9" in out


def test_serve_batched_torch_example_serves_reduced_mixtral_on_the_cpu(
        capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "serve_batched_torch.py")
    spec = importlib.util.spec_from_file_location("serve_batched_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    done = example.main(["--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(8))
    assert all(len(r.generated) == 16 for r in done)
    out = capsys.readouterr().out
    assert "arch=mixtral-8x7b-smoke device=cpu requests=8 new_tokens=128" \
        in out
