"""The port's training step (``repro_torch.runtime.steps``,
``repro_torch.optim``) against the JAX package's, on CPU tensors.

For each of the ten registry archs reduced, in f32, the reference's
``Model.init`` weights carried into the port (``tests/torch_lm_cases.py``)
and one numpy batch on both sides:

* the loss and every parameter's gradient (``model.loss(remat=True)``; the
  reference's stacked gradients flattened to the port's names) within 1e-4
  of scale, and the learning rate;
* AdamW applied to the reference's own gradients, carried as numpy, within
  1e-6 of scale of the reference's ``adamw_update`` on them;
* the full step's weights (``make_train_step``) under a looser rule, at
  most 1e-4 of the elements beyond 1e-4 of scale and every element within
  ``2 lr (1 + weight_decay |p|)`` of the reference (plus one rounding of
  the weight's dtype in each package).  Why: AdamW's
  ``m_hat / (sqrt(v_hat) + eps)`` turns a gradient near zero whose sign
  differs by rounding between the two packages into a step of up to
  ``lr`` either way, so weights after a whole step cannot be held element
  by element at the gradients' bound.

llama3-8b, granite-moe and whisper repeat it in bf16 at the reference's
2e-2 (AdamW on the same gradients and the full step's share of elements
then held at 2e-2 of scale too: a bf16 weight moves by whole bf16 steps).
``accum`` 2 is held against the reference's ``accum`` 2, and the
reference's ``test_train_loss_decreases_over_steps`` (8 AdamW steps at lr
5e-3 on one batch) runs on both packages in f32, each loss within 1e-4 of
the reference's scale.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs.registry import ARCH_IDS
from repro_torch.models.transformer import _flatten
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.steps import loss_and_grads, make_train_step

from torch_lm_cases import (BF16_ARCHS, BF16_TOL, F32_TOL, batches, carried,
                            configs, one_intra_op_thread,  # noqa: F401
                            rel_err, to_numpy)

SCHED = dict(peak_lr=1e-3, warmup=0, total=10)   # lr = peak at step 0
WD = 0.1                                         # adamw's default decay


def flat(tree):
    """The reference's pytree (stacked layers) under the port's names."""
    out = {}
    _flatten(to_numpy(tree), "", out)
    return out


def as_f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def check_full_step(model, ref_params, lr, tol=F32_TOL):
    """The full step's rule (see the module docstring): at most 1e-4 of
    the elements beyond ``tol`` of scale, and every element within ``2 lr
    (1 + WD |p|)`` of the reference, plus one rounding of the parameter's
    dtype in each package."""
    want = flat(ref_params)
    beyond, total = 0, 0
    for n, p in model.named_parameters():
        got = p.detach().float().numpy()
        w = as_f32(want[n])
        err = np.abs(got - w)
        scale = max(1.0, float(np.abs(w).max()))
        beyond += int((err > tol * scale).sum())
        total += err.size
        eps = torch.finfo(p.dtype).eps
        bound = 2 * lr * (1 + WD * np.abs(w)) + 2 * eps * np.abs(w) + 1e-7
        assert (err <= bound).all(), (n, float((err - bound).max()))
    assert beyond <= 1e-4 * total, (beyond, total)


def reference_step(jm, params, jb):
    """The reference's loss, gradients, lr and AdamW on its gradients,
    jitted as its launcher jits its train step."""
    @jax.jit
    def step(params, jb):
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss(p, jb, remat=True))(params)
        opt = j_adamw_init(params)
        lr = j_cosine_schedule(opt["step"], **SCHED)
        new, _ = j_adamw_update(grads, opt, params, lr)
        return loss, grads, lr, new
    loss, grads, lr, new = step(params, jb)
    return float(loss), grads, float(lr), new


def run_case(arch, dtype, tol):
    jc, pc = configs(arch, dtype)
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc)
    r_loss, r_grads, r_lr, r_new = reference_step(jm, params, jb)
    want = flat(r_grads)

    # loss and gradients
    pm.requires_grad_(True)
    loss, grads = loss_and_grads(pm, tb)
    assert set(grads) == set(want)
    assert abs(float(loss) - r_loss) / max(1.0, abs(r_loss)) < tol
    for n, g in grads.items():
        assert g.dtype == dict(pm.named_parameters())[n].dtype
        assert rel_err(g, as_f32(want[n])) < tol, n

    # AdamW on the reference's own gradients
    lr = cosine_schedule(0, **SCHED)
    assert abs(float(lr) - r_lr) <= 1e-9
    same = copy.deepcopy(pm)
    params_same = dict(same.named_parameters())
    g_ref = {n: torch.from_numpy(as_f32(want[n])).to(p.dtype)
             for n, p in params_same.items()}
    adamw_update(g_ref, adamw_init(params_same), params_same, lr)
    new = flat(r_new)
    ada_tol = 1e-6 if dtype == "float32" else tol
    for n, p in params_same.items():
        assert rel_err(p.detach(), as_f32(new[n])) < ada_tol, n

    # the full step
    step = make_train_step(pm, **SCHED)
    opt = adamw_init(dict(pm.named_parameters()))
    opt, m = step(pm, opt, tb)
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
    assert float(m["lr"]) == pytest.approx(r_lr)
    check_full_step(pm, r_new, r_lr, tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference_f32(arch):
    run_case(arch, "float32", F32_TOL)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_train_step_matches_reference_bf16(arch):
    run_case(arch, "bfloat16", BF16_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-3b-a800m"])
def test_accumulation_matches_reference(arch):
    """``accum`` 2 over a batch of 4 (microbatches rows 0, 2 and 1, 3):
    the loss and f32 gradients against the reference's strided split
    summed in f32, and the full step against the reference's ``accum``
    2 ``make_train_step``."""
    jc, pc = configs(arch)
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc, b=4)
    micro = [{k: v[i::2] for k, v in jb.items()} for i in range(2)]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=True)))
    parts = [grad_fn(params, b) for b in micro]
    r_loss = (parts[0][0] + parts[1][0]) / 2
    r_grads = flat(jax.tree.map(lambda a, b: (a.astype(jnp.float32) + b) / 2,
                                parts[0][1], parts[1][1]))
    pm.requires_grad_(True)
    loss, grads = loss_and_grads(pm, tb, accum=2)
    assert abs(float(loss) - float(r_loss)) < F32_TOL * max(1.0, float(
        r_loss))
    for n, g in grads.items():
        assert g.dtype == torch.float32
        assert rel_err(g, r_grads[n]) < F32_TOL, n

    j_step = jax.jit(j_make_train_step(jm, accum=2, **SCHED))
    j_new, _, jm_out = j_step(params, j_adamw_init(params), jb)
    step = make_train_step(pm, accum=2, **SCHED)
    opt, m = step(pm, adamw_init(dict(pm.named_parameters())), tb)
    assert abs(float(m["loss"]) - float(jm_out["loss"])) < F32_TOL * max(
        1.0, float(jm_out["loss"]))
    check_full_step(pm, j_new, float(jm_out["lr"]))


def test_accumulation_rejects_an_uneven_split():
    jc, pc = configs("olmo-1b")
    _, _, pm = carried(jc, pc)
    _, tb = batches(jc, b=3)
    pm.requires_grad_(True)
    with pytest.raises(ValueError, match="does not divide"):
        loss_and_grads(pm, tb, accum=2)


def test_loss_and_grads_needs_trainable_weights():
    jc, pc = configs("olmo-1b")
    _, _, pm = carried(jc, pc)          # weights are created frozen
    _, tb = batches(jc)
    with pytest.raises(ValueError, match="requires_grad_"):
        loss_and_grads(pm, tb)


def test_train_loss_decreases_over_steps_on_both():
    """The reference's ``test_train_loss_decreases_over_steps`` (llama3-8b
    reduced, 8 AdamW steps at lr 5e-3 on one batch, its default weight
    decay), in f32 on both packages: each loss within 1e-4 of the
    reference's scale (at least 1), and both fall by more than 0.5.  The
    scale, not the loss itself: the batch is memorised and the last losses
    are below 0.03, where the two trajectories part by a few 1e-6
    (AdamW's sign sensitivity, each step compounding the last)."""
    jc, pc = configs("llama3-8b")
    jm, params, pm = carried(jc, pc)
    jb, tb = batches(jc)

    @jax.jit
    def j_step(params, opt):
        loss, grads = jax.value_and_grad(lambda p: jm.loss(p, jb))(params)
        params, opt = j_adamw_update(grads, opt, params, lr=5e-3)
        return params, opt, loss

    pm.requires_grad_(True)
    named = dict(pm.named_parameters())
    j_opt, opt = j_adamw_init(params), adamw_init(named)
    j_losses, losses = [], []
    for _ in range(8):
        params, j_opt, jl = j_step(params, j_opt)
        j_losses.append(float(jl))
        loss, grads = loss_and_grads(pm, tb)
        adamw_update(grads, opt, named, lr=5e-3)
        losses.append(float(loss))
    for a, b in zip(losses, j_losses):
        assert abs(a - b) < F32_TOL * max(1.0, abs(b)), (losses, j_losses)
    assert losses[-1] < losses[0] - 0.5, losses
    assert j_losses[-1] < j_losses[0] - 0.5, j_losses
