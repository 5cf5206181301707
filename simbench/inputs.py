"""The general generator: every input a run hands the port and the
reference, made from ``--seed`` alone.

- Draws: a configuration's ``draws`` names each lane's parameters and how
  they are drawn (``uniform`` in [low, high), ``index`` over n items, each
  also ``stratified``: one lane in each equal part of the range, the parts
  in an order drawn; a uniform unit ``quaternion`` with w >= 0). A traffic mix's ``draw_sets``
  names the sets a run draws (``target`` and ``start`` of a fit, the
  ``lanes`` of a rollout); with ``fresh_per_unit`` every unit draws anew.
  Each (seed, set, unit) has its own ``torch.Generator`` on the CPU, so a
  unit's draws do not depend on how many units came before, and both sides
  get the same values.
- Decoder weights: IGR's geometric initialisation and the latent codes,
  the one decoder a deployment holds: drawn in one call from the seed the
  configuration states (``weights_seed``), the same on every machine, and
  moved to the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of the run seed ``seed`` (any
    whole number)."""
    s = int(seed) % (1 << 128)
    state = np.random.SeedSequence([s & 0xFFFFFFFFFFFFFFFF, s >> 64, *keys]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *keys: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *keys))


def draw(spec: dict, n: int, gen: torch.Generator) -> dict:
    """One value of each named parameter for each of n lanes (float64 or
    int64, on the CPU)."""
    out = {}
    for name in sorted(spec):
        d = spec[name]
        if d["kind"] == "uniform":
            out[name] = d["low"] + (d["high"] - d["low"]) * torch.rand(n, generator=gen, dtype=torch.float64)
        elif d["kind"] == "stratified":
            out[name] = d["low"] + (d["high"] - d["low"]) * _strata(n, gen)
        elif d["kind"] == "index":
            out[name] = torch.randint(0, d["n"], (n,), generator=gen)
        elif d["kind"] == "stratified_index":
            out[name] = torch.floor(_strata(n, gen) * d["n"]).to(torch.int64)
        elif d["kind"] == "quaternion":
            q = torch.randn((n, 4), generator=gen, dtype=torch.float64)
            q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
            out[name] = torch.where(q[:, :1] < 0, -q, q)
        else:
            raise ValueError(f"draw kind {d['kind']!r}: uniform, stratified, index, stratified_index or quaternion")
    return out


def _strata(n: int, gen: torch.Generator):
    """n values in [0, 1), one uniform in each n-th of it, in an order drawn
    from ``gen``: every draw covers the range alike, so the work of a batch
    hardly depends on the seed."""
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    return (torch.randperm(n, generator=gen).to(torch.float64) + u) / n


def draws(config: dict, traffic: dict, seed: int, set_name: str, unit: int = 0) -> dict:
    """The draws of ``set_name`` for ``unit`` (fixed per run unless the
    traffic draws fresh per unit)."""
    s = traffic["draw_sets"].index(set_name)
    u = unit + 1 if traffic.get("fresh_per_unit") else 0
    return draw(config["draws"], config["lanes"], generator(seed, 1, s, u))


def decoder_weights(config: dict, device, dtype=torch.float64):
    """(weights, biases, codes) of the configuration's decoder: IGR's
    geometric initialisation toward a sphere of ``radius_init`` (hidden
    weights N(0, 2 / out), zero biases, the last layer sqrt(pi / in) with
    bias -radius_init) and ``codes`` latent codes N(0, code_std^2), all from
    one draw of the configuration's ``weights_seed``, on ``device``."""
    d = config["decoder"]
    d_in = 3 + d["latent_size"]
    full = [d_in] + list(d["dims"]) + [1]
    shapes = []
    for layer in range(len(full) - 1):
        out_dim = full[layer + 1] - d_in if layer + 1 in d["skip_in"] else full[layer + 1]
        shapes.append((out_dim, full[layer]))
    n_hidden = sum(o * i for o, i in shapes[:-1])
    n_codes = d["codes"] * d["latent_size"]
    z = torch.randn(n_hidden + n_codes, generator=generator(d["weights_seed"], 2), dtype=torch.float64)
    z = z.to(device=device, dtype=dtype)
    weights, biases, at = [], [], 0
    for o, i in shapes[:-1]:
        weights.append(z[at:at + o * i].reshape(o, i) * (math.sqrt(2.0) / math.sqrt(o)))
        biases.append(torch.zeros(o, dtype=dtype, device=device))
        at += o * i
    o, i = shapes[-1]
    weights.append(torch.full((o, i), math.sqrt(math.pi) / math.sqrt(i), dtype=dtype, device=device))
    biases.append(torch.full((o,), -d["radius_init"], dtype=dtype, device=device))
    codes = z[at:].reshape(d["codes"], d["latent_size"]) * d["code_std"]
    return weights, biases, codes
