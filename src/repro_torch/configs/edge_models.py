"""The paper's benchmark models (§4) as planner layer graphs.

MobileNet v1 (224x224), ResNet-18 / ResNet-101 (224x224) and BERT-base
(seq 128), plus a small Inception-style model.  ResNet blocks carry **real
residual edges** (``LayerSpec.inputs``) — the ADD layers are true two-input
merges, with 1x1 projection convs on downsampling skips — and the Inception
modules merge four parallel branches with CONCAT.  BERT blocks are modelled
as FC/matmul chains (ConvT.FC), which reproduces the paper's observation
that scheme choice barely matters for matmul-dominated models.  Plain
chains (MobileNet, BERT) still use the ``chain`` constructor, so every
pre-existing call site keeps working unchanged.

A copy of the JAX package's ``configs/edge_models.py``.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.graph import ConvT, LayerSpec, ModelGraph, chain


def _conv(name, h, w, cin, cout, k, s, p, t=ConvT.CONV,
          inputs=()) -> LayerSpec:
    return LayerSpec(name, t, h, w, cin, cout, k, s, p, inputs=tuple(inputs))


def mobilenet_v1(width: int = 224) -> ModelGraph:
    layers: List[LayerSpec] = []
    h = w = width

    def add(l: LayerSpec):
        layers.append(l)
        return l.out_h, l.out_w

    h, w = add(_conv("conv0", h, w, 3, 32, 3, 2, 1))
    cfg = [  # (dw stride, pointwise out channels)
        (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
        (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
    ]
    cin = 32
    for i, (s, cout) in enumerate(cfg):
        h, w = add(_conv(f"dw{i+1}", h, w, cin, cin, 3, s, 1, ConvT.DWCONV))
        h, w = add(_conv(f"pw{i+1}", h, w, cin, cout, 1, 1, 0, ConvT.POINTWISE))
        cin = cout
    h, w = add(_conv("avgpool", h, w, 1024, 1024, int(h), int(h), 0, ConvT.POOL))
    layers.append(LayerSpec("fc", ConvT.FC, 1, 1, 1024, 1000))
    return chain("mobilenet", layers)


def _res_block(layers, name, h, w, cin, cout, stride, src) -> tuple:
    """Basic block with a real residual edge; projection conv on the skip
    when the main path changes shape."""
    layers.append(_conv(f"{name}a", h, w, cin, cout, 3, stride, 1,
                        inputs=(src,)))
    oh, ow = layers[-1].out_h, layers[-1].out_w
    layers.append(_conv(f"{name}b", oh, ow, cout, cout, 3, 1, 1,
                        inputs=(f"{name}a",)))
    skip = src
    if stride != 1 or cin != cout:
        layers.append(_conv(f"{name}s", h, w, cin, cout, 1, stride, 0,
                            ConvT.POINTWISE, inputs=(src,)))
        skip = f"{name}s"
    layers.append(LayerSpec(f"{name}+", ConvT.ADD, oh, ow, cout, cout,
                            inputs=(f"{name}b", skip)))
    return oh, ow, f"{name}+"


def _bottleneck(layers, name, h, w, cin, cmid, cout, stride, src) -> tuple:
    layers.append(_conv(f"{name}a", h, w, cin, cmid, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(src,)))
    layers.append(_conv(f"{name}b", h, w, cmid, cmid, 3, stride, 1,
                        inputs=(f"{name}a",)))
    oh, ow = layers[-1].out_h, layers[-1].out_w
    layers.append(_conv(f"{name}c", oh, ow, cmid, cout, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(f"{name}b",)))
    skip = src
    if stride != 1 or cin != cout:
        layers.append(_conv(f"{name}s", h, w, cin, cout, 1, stride, 0,
                            ConvT.POINTWISE, inputs=(src,)))
        skip = f"{name}s"
    layers.append(LayerSpec(f"{name}+", ConvT.ADD, oh, ow, cout, cout,
                            inputs=(f"{name}c", skip)))
    return oh, ow, f"{name}+"


def resnet18(width: int = 224) -> ModelGraph:
    layers: List[LayerSpec] = []
    h = w = width
    layers.append(_conv("conv1", h, w, 3, 64, 7, 2, 3))
    h, w = layers[-1].out_h, layers[-1].out_w
    layers.append(_conv("maxpool", h, w, 64, 64, 3, 2, 1, ConvT.POOL))
    h, w = layers[-1].out_h, layers[-1].out_w
    plan = [(64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
            (512, 2), (512, 1)]
    cin, src = 64, "maxpool"
    for i, (cout, s) in enumerate(plan):
        h, w, src = _res_block(layers, f"b{i}", h, w, cin, cout, s, src)
        cin = cout
    layers.append(_conv("avgpool", h, w, 512, 512, int(h), int(h), 0,
                        ConvT.POOL, inputs=(src,)))
    layers.append(LayerSpec("fc", ConvT.FC, 1, 1, 512, 1000))
    return ModelGraph(name="resnet18", layers=tuple(layers))


def resnet101(width: int = 224) -> ModelGraph:
    layers: List[LayerSpec] = []
    h = w = width
    layers.append(_conv("conv1", h, w, 3, 64, 7, 2, 3))
    h, w = layers[-1].out_h, layers[-1].out_w
    layers.append(_conv("maxpool", h, w, 64, 64, 3, 2, 1, ConvT.POOL))
    h, w = layers[-1].out_h, layers[-1].out_w
    stages = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 23, 2),
              (512, 2048, 3, 2)]
    cin, src = 64, "maxpool"
    for si, (cmid, cout, reps, stride) in enumerate(stages):
        for r in range(reps):
            h, w, src = _bottleneck(layers, f"s{si}r{r}", h, w, cin, cmid,
                                    cout, stride if r == 0 else 1, src)
            cin = cout
    layers.append(_conv("avgpool", h, w, 2048, 2048, int(h), int(h), 0,
                        ConvT.POOL, inputs=(src,)))
    layers.append(LayerSpec("fc", ConvT.FC, 1, 1, 2048, 1000))
    return ModelGraph(name="resnet101", layers=tuple(layers))


def _inception_module(layers, name, h, w, cin, c1, c3r, c3, c5r, c5, cp,
                      src) -> tuple:
    """GoogLeNet-style module: four parallel branches joined by CONCAT."""
    layers.append(_conv(f"{name}.1x1", h, w, cin, c1, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(src,)))
    layers.append(_conv(f"{name}.3r", h, w, cin, c3r, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(src,)))
    layers.append(_conv(f"{name}.3x3", h, w, c3r, c3, 3, 1, 1,
                        inputs=(f"{name}.3r",)))
    layers.append(_conv(f"{name}.5r", h, w, cin, c5r, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(src,)))
    layers.append(_conv(f"{name}.5x5", h, w, c5r, c5, 5, 1, 2,
                        inputs=(f"{name}.5r",)))
    layers.append(_conv(f"{name}.pool", h, w, cin, cin, 3, 1, 1,
                        ConvT.POOL, inputs=(src,)))
    layers.append(_conv(f"{name}.pp", h, w, cin, cp, 1, 1, 0,
                        ConvT.POINTWISE, inputs=(f"{name}.pool",)))
    cat = c1 + c3 + c5 + cp
    layers.append(LayerSpec(f"{name}.cat", ConvT.CONCAT, h, w, cat, cat,
                            inputs=(f"{name}.1x1", f"{name}.3x3",
                                    f"{name}.5x5", f"{name}.pp")))
    return cat, f"{name}.cat"


def inception_small(width: int = 64) -> ModelGraph:
    """Two stacked Inception modules over a small stem — the branched
    planning benchmark (GoogLeNet-style fork/concat topology)."""
    layers: List[LayerSpec] = []
    h = w = width
    layers.append(_conv("stem", h, w, 3, 32, 3, 2, 1))
    h = w = layers[-1].out_h
    cin, src = 32, "stem"
    cin, src = _inception_module(layers, "i1", h, w, cin,
                                 16, 12, 24, 4, 8, 8, src)
    cin, src = _inception_module(layers, "i2", h, w, cin,
                                 24, 16, 32, 6, 12, 12, src)
    layers.append(_conv("avgpool", h, w, cin, cin, int(h), int(h), 0,
                        ConvT.POOL, inputs=(src,)))
    layers.append(LayerSpec("fc", ConvT.FC, 1, 1, cin, 100))
    return ModelGraph(name="inception_small", layers=tuple(layers))


def bert_base(seq: int = 128, d: int = 768, n_layers: int = 12,
              d_ff: int = 3072) -> ModelGraph:
    """BERT as a matmul chain: per block QKV proj, attn-out proj (attention
    score matmuls folded into extra_flop_factor), two FFN matmuls."""
    layers: List[LayerSpec] = []
    for i in range(n_layers):
        layers.append(LayerSpec(f"b{i}.qkv", ConvT.FC, seq, 1, d, 3 * d))
        # attention matmuls ~ 2*seq*seq*d flops folded into the out-proj
        attn_extra = 1.0 + (2.0 * seq * seq * d) / (2.0 * seq * 3 * d * d)
        layers.append(LayerSpec(f"b{i}.attn_out", ConvT.FC, seq, 1, 3 * d, d,
                                extra_flop_factor=attn_extra))
        layers.append(LayerSpec(f"b{i}.ffn_up", ConvT.FC, seq, 1, d, d_ff))
        layers.append(LayerSpec(f"b{i}.ffn_down", ConvT.FC, seq, 1, d_ff, d))
    return chain("bert", layers)


EDGE_MODELS = {
    "mobilenet": mobilenet_v1,
    "resnet18": resnet18,
    "resnet101": resnet101,
    "inception": inception_small,
    "bert": bert_base,
}
