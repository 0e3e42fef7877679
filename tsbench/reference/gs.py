"""Plain Grep&Sum: every transaction in timestamp order, one after another.

Written from the TStream paper (Sec. VI-A, Fig. 5) and the port's
``apps/gs.py`` docstring, not from the port's code.  A read event returns
the value each of its records holds after every earlier event; its output
``sum`` is the sum of those values (0 for a write event), and ``ok`` is
always true.  A write event sets each of its records to its value.  Keys are
distinct within a transaction, so the order of its accesses does not
matter.

Sequential semantics are evaluated without a loop: after a stable sort of
the stream's accesses by record, the value an access reads is that of the
last write before it in its record's run, or the state the block started
from.  ``dtype`` is the precision of the state and of the arithmetic:
float32 as the configuration states, bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch

# per-event outputs and how each is compared: "gap" by value, "exact" by count
OUTPUTS = {"sum": "gap", "ok": "exact"}


def step(state: torch.Tensor, ev: dict, dtype=torch.float32):
    """One block of events after ``state`` [n_keys] (of ``dtype``).  Returns
    ({"sum": float32 [m], "ok": bool [m]}, the state after the block)."""
    keys = ev["keys"].long()
    m, w = keys.shape
    n = m * w
    dev = keys.device
    is_read = ev["is_read"]
    write = (~is_read)[:, None].expand(m, w).reshape(-1)
    vals = ev["values"].to(dtype).reshape(-1)
    ks, order = torch.sort(keys.reshape(-1), stable=True)
    ws, vs = write[order], vals[order]
    idx = torch.arange(n, device=dev)
    last = torch.cummax(torch.where(ws, idx, torch.full_like(idx, -1)),
                        0).values
    first = torch.searchsorted(ks, ks)          # start of each record's run
    before = torch.cat([last.new_full((1,), -1), last[:-1]])
    seen = before >= first
    pre_s = torch.where(seen, vs[before.clamp(min=0)], state[ks])
    pre = torch.empty_like(pre_s)
    pre[order] = pre_s
    total = pre.view(m, w).sum(-1) * is_read
    end = torch.ones(n, dtype=torch.bool, device=dev)
    end[:-1] = ks[1:] != ks[:-1]
    wrote = end & (last >= first)
    new = state.clone()
    new[ks[wrote]] = vs[last[wrote]]
    return dict(sum=total.float(), ok=torch.ones(m, dtype=torch.bool,
                                                 device=dev)), new


def run(state: np.ndarray, blocks, *, dtype: str = "float32",
        device: str = "cpu"):
    """The stream ``blocks`` (dicts of numpy columns, in stream order) from
    ``state`` (float32 [n_keys]).  Returns (per-event outputs as numpy
    arrays, the final state as float32 numpy)."""
    dt = getattr(torch, dtype)
    st = torch.from_numpy(np.asarray(state, np.float32)).to(device).to(dt)
    outs = {k: [] for k in OUTPUTS}
    for ev in blocks:
        ev = {k: torch.from_numpy(np.asarray(v)).to(device)
              for k, v in ev.items()}
        o, st = step(st, ev, dt)
        for k in OUTPUTS:
            outs[k].append(o[k].cpu().numpy())
    dts = {"sum": np.float32, "ok": bool}
    return ({k: np.concatenate(v) if v else np.zeros(0, dts[k])
             for k, v in outs.items()}, st.float().cpu().numpy())
