"""The one general generator: a configuration's sensing matrix and a traffic
mix's pool of signals, drawn on the device from the run's seed.

A is Gaussian with unit l2 columns (the Donoho-Tanner ensemble of the
configurations). A signal is k-sparse on a support drawn uniformly, with
amplitudes drawn uniformly from the mix's ``amplitude`` range; y = A x is
formed in float64 and rounded once to the configuration's dtype. A mix
with ``k_min`` < ``k_max`` sends every k of that range once in each block
of ``k_max - k_min + 1`` calls, in an order drawn from the seed, so every
seed does the same work in another order.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of the pool drawn at once: bounds the (rows, n) keys and the
# float64 (rows, k, m) product that forms y
_CHUNK_ELEMS = 1 << 24


def _sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed (any
    whole number) and the stream's tag."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(device, seed: int, tag: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_sub_seed(seed, tag))
    return g


def sensing_matrix(config: dict, seed: int, device) -> torch.Tensor:
    """The (m, n) matrix of the configuration, in its dtype, in one draw."""
    dtype = getattr(torch, config["dtype"])
    A = torch.randn(config["m"], config["n"], generator=_generator(
        device, seed, 1), device=device, dtype=dtype)
    A /= torch.linalg.vector_norm(A, dim=0)
    return A


def sparsities(traffic: dict, seed: int) -> np.ndarray:
    """The k of every signal in the pool, in call order (host array)."""
    lo, hi = traffic["k_min"], traffic["k_max"]
    count = traffic["pool_calls"] * traffic["batch"]
    rng = np.random.Generator(np.random.PCG64(_sub_seed(seed, 2)))
    block = np.arange(lo, hi + 1)
    blocks = -(-count // len(block))
    return np.concatenate([rng.permutation(block)
                           for _ in range(blocks)])[:count]


def signal_pool(A: torch.Tensor, traffic: dict, seed: int):
    """(Y (calls, batch, m), ks (calls, batch)): the pool the window cycles
    through, call by call."""
    m, n = A.shape
    ks = sparsities(traffic, seed)
    count, kmax = len(ks), int(ks.max())
    g = _generator(A.device, seed, 3)
    lo, hi = traffic["amplitude"]
    Y = torch.empty((count, m), dtype=A.dtype, device=A.device)
    kt = torch.as_tensor(ks, device=A.device)
    rows = max(1, _CHUNK_ELEMS // max(n, kmax * m))
    for r0 in range(0, count, rows):
        r1 = min(count, r0 + rows)
        keys = torch.rand((r1 - r0, n), generator=g, device=A.device)
        support = keys.topk(kmax, dim=1).indices          # uniform, distinct
        amps = lo + (hi - lo) * torch.rand((r1 - r0, kmax), generator=g,
                                           device=A.device,
                                           dtype=torch.float64)
        live = torch.arange(kmax, device=A.device) < kt[r0:r1, None]
        amps = torch.where(live, amps, torch.zeros_like(amps))
        cols = A.T[support].to(torch.float64)            # (rows, kmax, m)
        Y[r0:r1] = torch.einsum("rk,rkm->rm", amps, cols).to(A.dtype)
    shape = (traffic["pool_calls"], traffic["batch"])
    return Y.reshape(*shape, m), ks.reshape(shape)
