"""Shared pieces of the LM-substrate conformance tests
(``tests/test_torch_models*.py``, ``tests/test_torch_ssm.py``): one config
on both packages, the reference's ``Model.init`` weights carried into the
port, the same numpy batch on both sides, and the scale-normalised error."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models.transformer import Model as JModel

from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import params_from_numpy
# re-exported for the tests that carry the port's weights back
from repro_torch.models.transformer import params_to_numpy  # noqa: F401

B, S = 2, 16
F32_TOL = 1e-4          # the reference's scale-normalised f32 bound
BF16_TOL = 2e-2         # the reference's bf16 bound
#: the archs held in bf16 (dense, moe, encdec)
BF16_ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "whisper-small")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The models are many small CPU ops; beside the other test workers,
    intra-op threads only contend, so these modules run them in one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_dryrun_shapes():
    """The reference dry run's ``SHAPES``, read from its source: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the whole process (512
    host devices), which would change the device count of every later JAX
    test in the same worker."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
           / "dryrun.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "SHAPES":
            return ast.literal_eval(node.value)
    raise LookupError("SHAPES not found in the reference's dryrun.py")


def configs(arch, dtype="float32", **kw):
    """(reference config, port config) of ``arch``'s ``reduced()`` variant
    with ``dtype`` and the fields ``kw`` replaced on both."""
    jc = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype, **kw)
    pc = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    return jc, pc


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def carried(jc, pc, seed=0):
    """(reference model, its params, the port's model on the CPU holding
    the same weights)."""
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, params_from_numpy(pc, to_numpy(params), "cpu")


def batches(cfg, b=B, s=S, seed=0, tokens=None):
    """The same batch for both packages: (jax dict, torch dict); tokens,
    vision and audio embeddings drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) \
        if tokens is None else np.asarray(tokens, np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(toks).long()}
    extra = {"vlm": ("vision_embeds", cfg.vision_tokens),
             "encdec": ("audio_embeds", cfg.enc_seq)}.get(cfg.family)
    if extra:
        key, n = extra
        e = (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(
            np.float32)
        jb[key], tb[key] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def rel_err(a, b) -> float:
    """Max abs deviation of ``a`` from the reference ``b`` over ``b``'s
    scale (at least 1), in f32."""
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))
