"""The plain references against the port at a tiny size on the CPU: the
same weights through the port's entry points and through the reference
give the same logits.  And the controls' roundings."""
import dataclasses

import pytest
import torch

from bench import weights
from bench.reference import flexpie_block, olmo, precision

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128,
        "vocab": 256}


def scaled_err(a, b):
    return float((a - b).abs().max() / b.std())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def olmo_model(n_kv):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model
    widths = dict(TINY, n_kv=n_kv, head_dim=0, rope_theta=10000.0)
    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32",
                              **{k: v for k, v in widths.items()
                                 if k != "head_dim"})
    model = Model(cfg, device="cpu")
    w = weights.draw(olmo.layout(widths), 7, torch.float32, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model, w, widths


@pytest.mark.parametrize("n_kv", [4, 2])
def test_olmo_reference_equals_the_port_forward(n_kv):
    model, w, widths = olmo_model(n_kv)
    tokens = torch.randint(0, 256, (24,), generator=torch.Generator()
                           .manual_seed(3))
    port = model.forward({"tokens": tokens[None]})[0][0]
    ref = olmo.logits(w, widths, tokens, torch.arange(24))
    assert scaled_err(port, ref) < 1e-5


def test_the_serving_driver_refuses_a_block_its_reference_does_not_compute():
    from bench.drivers import serve_generate
    from bench.harness import load_cell
    config = load_cell("olmo-1b.serve.short").config
    assert serve_generate.model_config(config).norm == "nonparam_ln"
    other = dict(config, model=dict(config["model"], norm="rmsnorm"),
                 reduced=["norm"])
    with pytest.raises(ValueError, match="OLMo reference"):
        serve_generate.model_config(other)


def test_olmo_reference_equals_the_served_step_logits():
    from repro_torch.launch.serve import generate
    model, w, widths = olmo_model(4)
    prompts = torch.randint(0, 256, (3, 10), generator=torch.Generator()
                            .manual_seed(4))
    res = generate(model, prompts, 5)
    for b in range(3):
        toks = torch.cat([prompts[b], res.tokens[b]])
        ref = olmo.logits(w, widths, toks, torch.arange(15))
        port = torch.stack([lg[b] for lg in res.step_logits])
        assert scaled_err(port, ref) < 1e-5
        # each served token is the argmax of its step's logits
        assert torch.equal(ref[9:14].argmax(-1), res.tokens[b])


def test_flexpie_reference_equals_the_port_oracle_and_session():
    from repro_torch.runtime.decode import (DecodeSession, TransformerSpec,
                                            greedy_decode, plan_decode,
                                            reference_decode)
    from repro_torch.runtime.session import ExecConfig
    spec = TransformerSpec(**TINY)
    w = flexpie_block.nest(weights.draw(flexpie_block.layout(TINY), 8,
                                        torch.float32, "cpu"), 2)
    prompt = [5, 17, 200, 3, 99, 42, 7, 250]
    toks, lg = reference_decode(spec, w, prompt, 6)
    ref = flexpie_block.logits(w, TINY, torch.tensor(prompt + toks),
                               torch.arange(7, 13))
    assert scaled_err(lg, ref) < 1e-5
    plan = plan_decode(spec, 32, 4).plan
    sess = DecodeSession(spec, w, plan, 4, ExecConfig(
        executor="mesh", device="cpu"), page_size=4, capacity=32)
    toks_m, lg_m = greedy_decode(sess, prompt, 6)
    assert toks_m == toks and scaled_err(lg_m, ref) < 1e-5


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1)) * 3
    r = precision.tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(precision.tf32(r), r)
    assert float((r - x).abs().max()) > 0


def test_fp8_rounds_to_the_format_at_a_per_tensor_scale():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2)) * 1e-3
    r = precision.fp8_e4m3(x)
    scale = float(x.abs().max()) / precision.FP8_MAX
    back = (r / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.allclose(back, r, rtol=0, atol=0)
    rel = ((r - x).abs() / x.abs().clamp_min(scale * 2 ** -6)).max()
    assert 2.0 ** -5 <= float(rel) <= 2.0 ** -4 + 1e-6
