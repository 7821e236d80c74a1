"""The frozen formulas against hand counts at small shapes, and against
the port's own parameter counts."""
import dataclasses

import pytest

from bench.work import flops


def small(**kw):
    c = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "d_head": 4, "d_ff": 0, "moe_d_ff": 6,
         "n_experts": 4, "top_k": 2, "vocab_size": 10, "qk_norm": True,
         "qkv_bias": False, "tie_embeddings": False}
    c.update(kw)
    return c


def test_param_counts_by_hand():
    c = small()
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 2 * 4          # wq wk wv wo, qk norms
    layer = 2 * 8 + attn + 8 * 4 + 4 * 3 * 8 * 6       # norms, router, experts
    total = 2 * 10 * 8 + 8 + 2 * layer
    got = flops.param_counts(c)
    assert got["total"] == total
    assert got["active"] == total - 2 * 2 * 3 * 8 * 6
    assert got["embed"] == 80
    assert flops.flops_params(c) == got["active"] - 80


def test_dense_counts_by_hand():
    c = small(family="dense", n_experts=0, top_k=0, moe_d_ff=0, d_ff=12,
              qk_norm=False, tie_embeddings=True)
    layer = 2 * 8 + (8 * 8 + 2 * 8 * 4 + 8 * 8) + 3 * 8 * 12
    assert flops.param_counts(c)["total"] == 10 * 8 + 8 + 2 * layer


def test_train_and_prefill_flops_by_hand():
    c = small()
    n = flops.flops_params(c)
    per_pair = 4 * 2 * 4 * 2                           # 4 H dh, 2 layers
    assert flops.train_step_flops(c, 3, 5) == 6 * n * 15 + 3 * per_pair * 3 * 15
    assert flops.prefill_flops(c, [2, 3]) == 2 * n * 5 + per_pair * (3 + 6)


def test_attention_and_decode_work_by_hand():
    f, b = flops.attention_work(1, 3, 3, 2, 1, 4, True)
    assert f == 4 * 2 * 4 * 6 and b == 2 * (2 * 3 * 2 * 4 + 2 * 3 * 1 * 4)
    f, b = flops.attention_work(2, 3, 5, 2, 1, 4, False)
    assert f == 4 * 2 * 2 * 4 * 15
    f, b = flops.decode_work(2, 4, 2, 8, 9)
    assert f == 4 * 2 * 4 * 8 * 10 and b == 2 * (2 * 2 * 2 * 10 * 8 + 2 * 2 * 4 * 8)
    assert flops.least_seconds(10, 4, 5, 1) == 4.0


@pytest.mark.parametrize("arch, file", [
    ("olmoe-1b-7b", "olmoe-1b-7b-pp4"), ("pixtral-12b", "pixtral-12b")])
def test_counts_match_the_port(arch, file):
    from bench.core.harness import ROOT, load_json
    from repro_torch.configs import get_config
    from repro_torch.models.model import active_param_count, param_count
    c = load_json(ROOT / "bench" / "configs" / f"{file}.json")["config"]
    cfg = dataclasses.replace(get_config(arch), n_layers=c["n_layers"])
    got = flops.param_counts(c)
    assert got["total"] == param_count(cfg)
    assert got["active"] == active_param_count(cfg)
