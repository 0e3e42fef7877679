"""Plain Streaming Ledger: every transaction in timestamp order, in a loop.

Written from the TStream paper (Sec. VI-A, Fig. 6) and the port's
``apps/sl.py`` docstring, not from the port's code.  The state is one
balance per account (slots [0, n_keys)) and per asset (slots [n_keys,
2 n_keys)).

* A deposit adds its amount to the source account and the source asset.
* A transfer debits the source account and the source asset, each only if
  its balance covers the amount (a bounded take; a debit that is not
  covered leaves the balance as it is and fails).  The destination account
  is credited only if the account debit succeeded, the destination asset
  only if the asset debit did.  A failed debit rolls nothing back.

Outputs per event: ``ok`` (both debits, or both deposit legs, succeeded),
``src_balance`` (the source account's balance after the event) and
``rejected`` (a transfer that is not ok).  The gated credits make each
transaction depend on the outcome of earlier ones, so the events run one by
one.  Balances are stored in an ``array("f")``: each sum or difference of
two float32 values is worked out exactly in double and rounded once to
float32 on the store, which is float32 arithmetic.  ``dtype="bfloat16"``
rounds every stored balance and amount to bfloat16 instead (the control).
"""
from __future__ import annotations

import struct
from array import array

import numpy as np

OUTPUTS = {"ok": "exact", "src_balance": "gap", "rejected": "exact"}


def _bf16(x: float) -> float:
    """``x`` rounded to bfloat16 (nearest, ties to even), via float32."""
    (bits,) = struct.unpack("<I", struct.pack("<f", x))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def run(state: np.ndarray, blocks, *, dtype: str = "float32",
        device: str = "cpu"):
    """The stream ``blocks`` (dicts of numpy columns, in stream order) from
    ``state`` (float32 [2 n_keys]).  Returns (per-event outputs as numpy
    arrays, the final state as float32 numpy).  ``device`` is unused: the
    loop runs on the host."""
    del device
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype={dtype!r}")
    low = dtype == "bfloat16"
    rnd = _bf16 if low else float
    state = np.asarray(state, np.float32)
    n_keys = state.shape[0] // 2
    acct = array("f", [rnd(x) for x in state[:n_keys].tolist()])
    asset = array("f", [rnd(x) for x in state[n_keys:].tolist()])
    ok_l, bal_l, rej_l = [], [], []
    for ev in blocks:
        cols = [np.asarray(ev[k]).tolist() for k in (
            "src_acct", "dst_acct", "src_asset", "dst_asset", "amount",
            "is_transfer")]
        m = len(cols[0])
        ok = np.zeros(m, bool)
        bal = np.zeros(m, np.float32)
        for i, (sa, da, ss, ds, amt, tr) in enumerate(zip(*cols)):
            amt = rnd(amt)
            if tr:
                b = acct[sa]
                ok0 = b >= amt
                if ok0:
                    acct[sa] = rnd(b - amt)
                c = asset[ss]
                ok1 = c >= amt
                if ok1:
                    asset[ss] = rnd(c - amt)
                if ok0:
                    acct[da] = rnd(acct[da] + amt)
                if ok1:
                    asset[ds] = rnd(asset[ds] + amt)
                ok[i] = ok0 and ok1
            else:
                acct[sa] = rnd(acct[sa] + amt)
                asset[ss] = rnd(asset[ss] + amt)
                ok[i] = True
            bal[i] = acct[sa]
        ok_l.append(ok)
        bal_l.append(bal)
        rej_l.append(np.asarray(ev["is_transfer"], bool) & ~ok)
    cat = lambda parts, dt: (np.concatenate(parts) if parts
                             else np.zeros(0, dt))
    final = np.concatenate([np.asarray(acct, np.float32),
                            np.asarray(asset, np.float32)])
    return (dict(ok=cat(ok_l, bool), src_balance=cat(bal_l, np.float32),
                 rejected=cat(rej_l, bool)), final)
