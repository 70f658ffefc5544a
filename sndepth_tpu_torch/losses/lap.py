"""Linear-sum assignment by a parallel (Jacobi) auction.

Counterpart of ``sndepth_tpu/losses/lap.py``, round for round: the same
epsilon (``rel_eps`` times the finite cost range), the same bids (every
unassigned person, a GT column, bids for its best object, a query row, at
``price + best - second + eps``), the same ties (the lowest object index
among equal values, the lowest person index among equal bids) and the same
displacement of an object's previous owner. Prices start at zero and are
not warm-started, so the total cost is within ``n_valid * eps`` of the
optimum. The rounds run as a Python loop over (ng, nq) tensor operations;
whether a round is left is read on the host once a round.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def auction_lap(cost: torch.Tensor, valid_cols: torch.Tensor,
                rel_eps: float = 1e-5, max_rounds: int = 10000,
                forbidden: float = 1e8) -> torch.Tensor:
    """Min-cost assignment of the valid columns of ``cost`` (nq, ng) to
    distinct rows. Returns (ng,) int32: the row of each valid column, -1
    for invalid columns (and for valid ones past the first nq). Entries at
    or above ``forbidden`` are left out of the epsilon's cost range."""
    nq, ng = cost.shape
    dev = cost.device
    value = -cost.t().to(torch.float32)                          # (ng, nq)
    person_valid = valid_cols & (torch.cumsum(valid_cols.to(torch.int32), 0)
                                 <= nq)
    finite = cost < forbidden
    inf = torch.full((), float("inf"), dtype=cost.dtype, device=dev)
    lo = torch.where(finite, cost, inf).min()
    hi = torch.where(finite, cost, -inf).max()
    span = hi - lo
    rng = torch.where(torch.isfinite(span), torch.clamp(span, min=1e-6),
                      torch.ones_like(span)).to(torch.float32)
    eps = rng * rel_eps

    person_obj = torch.where(person_valid, -1, -2).to(torch.int32)
    owner = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    price = torch.zeros(nq, dtype=torch.float32, device=dev)
    persons = torch.arange(ng, device=dev)
    objects = torch.arange(nq, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    for _ in range(max_rounds):
        unassigned = person_obj == -1
        if not bool(unassigned.any()):
            break
        net = value - price[None, :]
        best_j = torch.argmax(net, 1)
        best_v = net[persons, best_j]
        net2 = net.clone()
        net2[persons, best_j] = _NEG
        second_v = net2.max(1).values
        second_v = torch.where(second_v > _NEG / 2, second_v, best_v - rng)
        bid = price[best_j] + (best_v - second_v) + eps

        onehot = (best_j[:, None] == objects[None, :]) & unassigned[:, None]
        bidmat = torch.where(onehot, bid[:, None], neg)
        win_bid = bidmat.amax(0)
        win_person = torch.argmax(bidmat, 0).to(torch.int32)
        has_bid = win_bid > _NEG / 2

        price = torch.where(has_bid, win_bid, price)
        old_owner = owner
        owner = torch.where(has_bid, win_person, owner)
        displaced = has_bid & (old_owner >= 0) & (old_owner != win_person)
        person_obj = person_obj.clone()
        person_obj[old_owner[displaced].long()] = -1
        person_obj[win_person[has_bid].long()] = objects[has_bid].to(
            torch.int32)
    return torch.where(person_valid & (person_obj >= 0), person_obj,
                       torch.full_like(person_obj, -1))
