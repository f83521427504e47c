"""Seeded weights, made on the device from the run's seed in a few large
draws, in the dtype each model is run in.

The matcher: the GAT's Xavier-normal (gain 1.414) weights and uniform
biases, fp32.  Its last layer's bias is raised by the configuration's
``logit_shift``: a random matcher's logits sit near one value a draw
(about -1.3..1.6 over seeds), so without it half of all seeds would score
every pair under the threshold and decode nothing; with it every present
pair is eligible and every seed decodes, gathers and lifts the same kind
of work.  The lifter: torch.nn.Linear-style U(-1/sqrt(fan_in),
1/sqrt(fan_in)) weights and biases; served in bf16 (the weights rounded
once here, and handed to the program and the reference alike), trained in
fp32."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def matcher_dims(mcfg: dict) -> List[Tuple[int, int, int]]:
    """(in_dim, out_dim, heads) a layer."""
    dims, d_in = [], mcfg["in_dim"]
    for d, nh in zip(mcfg["hidden"], mcfg["heads"]):
        dims.append((d_in, d, nh))
        d_in = d * nh
    dims.append((d_in, mcfg["n_classes"], 1))
    return dims


def matcher_layers(mcfg: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    dims = matcher_dims(mcfg)
    normal = [(("attn_l", (nh, d), d, 1), ("attn_r", (nh, d), d, 1),
               ("w1", (di, di), di, di), ("w2", (di, nh * d), di, nh * d))
              for di, d, nh in dims]
    uniform = [(("b1", (di,), di), ("b2", (nh * d,), di)) for di, d, nh in dims]
    n_norm = sum(s[0] * s[1] for leaves in normal for _, s, _, _ in leaves)
    n_uni = sum(s[0] for leaves in uniform for _, s, _ in leaves)
    g = generator(seed, device, 1)
    zn = torch.randn(n_norm, generator=g, device=device)
    zu = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    layers, on, ou = [], 0, 0
    for leaves_n, leaves_u in zip(normal, uniform):
        layer = {}
        for name, shape, fi, fo in leaves_n:
            n = shape[0] * shape[1]
            std = 1.414 * (2.0 / (fi + fo)) ** 0.5
            layer[name] = (zn[on:on + n] * std).view(shape)
            on += n
        for name, shape, fi in leaves_u:
            layer[name] = zu[ou:ou + shape[0]] / fi ** 0.5
            ou += shape[0]
        layers.append(layer)
    layers[-1]["b2"] = layers[-1]["b2"] + float(mcfg["logit_shift"])
    return layers


def lifter_dims(lcfg: dict) -> List[Tuple[int, int]]:
    d = [lcfg["in_dim"], *lcfg["widths"], lcfg["out_dim"]]
    return list(zip(d[:-1], d[1:]))


def lifter_layers(lcfg: dict, seed: int, device, dtype
                  ) -> List[Dict[str, torch.Tensor]]:
    """Per layer {"w" [K, N] in ``dtype``, "b" [N] fp32}."""
    dims = lifter_dims(lcfg)
    n = sum(k * m + m for k, m in dims)
    u = torch.rand(n, generator=generator(seed, device, 2),
                   device=device) * 2.0 - 1.0
    layers, o = [], 0
    for k, m in dims:
        s = 1.0 / k ** 0.5
        w = (u[o:o + k * m] * s).view(k, m)
        b = u[o + k * m:o + k * m + m] * s
        o += k * m + m
        layers.append({"w": w.to(dtype), "b": b.clone()})
    return layers
