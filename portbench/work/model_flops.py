"""Model FLOPs: what a step or a request needs, counted from the
configuration's published widths (the benchmark's configuration file),
never from what the program runs.

N is the parameters that take part in a matrix product per token: the
attention projections, the MLP or the router and the top-k experts'
share of the expert weights, and the head (a tied head counts the table
once; an untied embedding is a lookup and counts nothing).  Norm scales
are left out.  The port's ``registry.count_flops_params`` counts the
same matrices (and the norm vectors, 2 L d + d more); its
``registry.model_flops`` leaves attention out, which is added here from
the visible (query, key) pairs of each sequence's own length."""
from __future__ import annotations

from . import flash


def dims(conf: dict) -> dict:
    """The sizes the counts need, from a configuration file's ``model``."""
    m = conf["model"]
    H = m["num_attention_heads"]
    return {"L": m["num_hidden_layers"], "d": m["hidden_size"], "H": H,
            "KH": m["num_key_value_heads"],
            "Dh": m.get("head_dim") or m["hidden_size"] // H,
            "f": m["intermediate_size"], "V": m["vocab_size"],
            "E": m.get("num_local_experts", 0),
            "k": m.get("num_experts_per_tok", 0),
            "tied": bool(m["tie_word_embeddings"])}


def matmul_params(conf: dict) -> int:
    """N of the 6 N T rule, active experts only."""
    s = dims(conf)
    d, f = s["d"], s["f"]
    attn = d * s["H"] * s["Dh"] * 2 + d * s["KH"] * s["Dh"] * 2
    if s["E"]:
        ffn = d * s["E"] + s["k"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return s["L"] * (attn + ffn) + s["V"] * d


def attention_fwd_flops(conf: dict, seq_len: int) -> float:
    """Forward attention FLOPs of one causal sequence over all layers."""
    s = dims(conf)
    f, _ = flash.work(1, seq_len, s["H"], s["KH"], s["Dh"], causal=True)
    return s["L"] * f


def decode_attention_flops(conf: dict, context: int) -> float:
    """Forward attention FLOPs of one decoded token against ``context``
    cached positions (itself included), over all layers."""
    s = dims(conf)
    return s["L"] * 4.0 * s["H"] * s["Dh"] * context


def train_flops(conf: dict, seq_len: int, n_seqs: int) -> float:
    """6 N T plus attention's forward and backward (3x the forward) over
    ``n_seqs`` sequences of ``seq_len`` tokens."""
    T = seq_len * n_seqs
    return 6.0 * matmul_params(conf) * T + \
        3.0 * n_seqs * attention_fwd_flops(conf, seq_len)


def serve_flops(conf: dict, prompt_len: int, new_tokens: int) -> float:
    """2 N T plus the attention one request needs: its prompt's own causal
    attention (unpadded) and each generated token fed back against its
    context.  The last generated token is not fed back."""
    n = matmul_params(conf)
    fl = 2.0 * n * prompt_len + attention_fwd_flops(conf, prompt_len)
    for j in range(max(new_tokens - 1, 0)):
        fl += 2.0 * n + decode_attention_flops(conf, prompt_len + j + 1)
    return fl
