"""Input generators of the benchmark: everything a run feeds the program,
made from ``--seed`` on the run's device.

Copies, rewritten to draw on the device with a ``torch.Generator`` in a
few large calls, of the program's own generators:

- :func:`risk_inputs` — ``mfm_tpu_torch/data/synthetic.synthetic_risk_inputs``
  (ret, cap, styles, industry, valid), with a ring of return panels and
  every industry populated by construction;
- :func:`sim_covs` — ``mfm_tpu_torch/models/eigen.simulated_eigen_covs``
  (the eigen Monte-Carlo's M sample covariances), drawn in float64;
- :func:`alpha_panel` and :func:`alpha_deck` — ``chip_smoke.alpha_workload``
  (config 5's close / volume / ret panel, forward returns and expressions).

The same seed gives the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for sub-stream ``stream`` of ``seed`` (any int)."""
    h = (int(seed) * _MIX + (stream + 1) * 0xBF58476D1CE4E5B9) & _MASK
    h ^= h >> 31
    return (h * 0x94D049BB133111EB) & _MASK


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def risk_inputs(T: int, N: int, P: int, Q: int, ring: int, seed: int,
                device) -> dict:
    """The rebuild's inputs: cap (T, N), styles (T, N, Q), industry (T, N)
    int32, valid (T, N) bool, and ``ring`` return panels (T, N), float32.

    As ``synthetic_risk_inputs``: standard-normal styles, returns of 1%
    daily volatility, one log-normal cap per stock (mean log 11), 3% of the
    cells out of the universe.  Every industry holds at least one stock and
    its first stock is in the universe on every date (the constraint matrix
    divides by the last industry's cap); the industries' sizes are the same
    for every seed."""
    if N < P:
        raise ValueError(f"N={N} stocks cannot populate P={P} industries")
    # the industries' sizes are one draw for every seed (a thin industry
    # conditions the regression, so sizes drawn per seed would change what
    # float32 gives from seed to seed); the seed deals the stocks to them
    sizes = torch.Generator().manual_seed(stream_seed(0, 3))
    codes = torch.cat([torch.arange(P), torch.randint(
        0, P, (N - P,), generator=sizes)]).to(device)
    g = generator(seed, 0, device)
    row = codes[torch.randperm(N, generator=g, device=device)].to(torch.int32)
    styles = torch.randn((T, N, Q), generator=g, device=device)
    cap = torch.exp(11.0 + torch.randn((1, N), generator=g, device=device))
    valid = torch.rand((T, N), generator=g, device=device) > 0.03
    first = (row[None, :] == torch.arange(P, device=device,
                                          dtype=torch.int32)[:, None]
             ).to(torch.int32).argmax(dim=1)
    valid[:, first] = True
    rets = [0.01 * torch.randn((T, N), generator=g, device=device)
            for _ in range(ring)]
    return {"rets": rets, "cap": cap.expand(T, N).contiguous(),
            "styles": styles, "industry": row.expand(T, N).contiguous(),
            "valid": valid}


def sim_covs(K: int, length: int, M: int, seed: int, device) -> torch.Tensor:
    """M sample covariances (``np.cov`` semantics) of standard-normal
    (K, length) draws, (M, K, K) float32; drawn and reduced in float64."""
    g = generator(seed, 1, device)
    d = torch.randn((M, K, length), generator=g, device=device,
                    dtype=torch.float64)
    d = d - d.mean(dim=-1, keepdim=True)
    return ((d @ d.transpose(-1, -2)) / (length - 1)).to(torch.float32)


def alpha_panel(T: int, N: int, seed: int, device) -> tuple:
    """Config 5's panel: close a log random walk (2% daily), volume
    log-normal (mean log 10), ret the close-to-close return (NaN on the
    first date), all float32; and the forward returns (ret one date ahead,
    NaN on the last).  Drawn in float64, as the original."""
    g = generator(seed, 2, device)
    f64 = torch.float64
    close = torch.exp(torch.cumsum(
        0.02 * torch.randn((T, N), generator=g, device=device, dtype=f64),
        dim=0))
    volume = torch.exp(10.0 + torch.randn((T, N), generator=g, device=device,
                                          dtype=f64))
    nan = torch.full((1, N), float("nan"), dtype=f64, device=device)
    ret = torch.cat([nan, close[1:] / close[:-1] - 1.0])
    panel = {"close": close.float(), "volume": volume.float(),
             "ret": ret.float()}
    fwd = torch.cat([panel["ret"][1:], nan.float()])
    return panel, fwd


def alpha_deck(traffic: dict) -> list:
    """The deck of expression sources, config 5's rule: expression i fills
    template i mod (number of templates) with the i-th lag, window and
    constant of the traffic's cycles (each list read cyclically)."""
    t, lags = traffic["templates"], traffic["lags"]
    wins, consts = traffic["windows"], traffic["consts"]
    return [t[i % len(t)].format(d=lags[i % len(lags)],
                                 w=wins[i % len(wins)],
                                 c=consts[i % len(consts)])
            for i in range(traffic["deck_size"])]


class DeckStream:
    """Requests of ``per_request`` expressions drawn from the deck: each
    pass over the deck is a permutation drawn from the seed, so every seed
    sends the same expressions per pass, in its own order."""

    def __init__(self, deck: list, per_request: int, seed: int):
        if len(deck) % per_request:
            raise ValueError("the deck must split into whole requests")
        self.deck, self.per = deck, per_request
        self.seed, self.passes, self.order = seed, 0, []

    def next(self) -> list:
        if not self.order:
            g = torch.Generator().manual_seed(stream_seed(self.seed,
                                                          100 + self.passes))
            self.order = torch.randperm(len(self.deck), generator=g).tolist()
            self.passes += 1
        take, self.order = self.order[:self.per], self.order[self.per:]
        return [self.deck[i] for i in take]
