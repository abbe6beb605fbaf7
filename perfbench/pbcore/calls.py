"""Records of the program's K1 and K8 calls in a traced window: the
program's kernel wrappers are wrapped where the main path calls them (the
module globals of its grid encoders and its row scatter), and each call's
logical shapes and dtypes are kept for :mod:`counts.bytes`, with the K1
variant that the program's dispatcher picks for the shape (which fixes how
many device kernels the call launches). Each call runs inside a ``pb::k1`` or
``pb::k8`` span, so that its device time holds all that the wrapper issues
on the device: the kernels and the output's zero fill."""

from __future__ import annotations

import contextlib

from torch.profiler import record_function


def _sites():
    from geneface_tpu_torch.ops import encoders, fused_grid, scatter

    return [(fused_grid, "launch_gather_rows", "k8"), (fused_grid, "launch_scatter_add_rows", "k1"),
            (encoders, "launch_gather_rows", "k8"), (encoders, "launch_scatter_add_rows", "k1"),
            (scatter, "launch_scatter_add_rows", "k1"), (scatter, "launch_gather_rows", "k8")]


@contextlib.contextmanager
def recording(calls: list):
    """Append ``(kernel, shape dict)`` of every K1/K8 call to ``calls``."""
    from geneface_tpu_torch.ops import scatter as sc

    sites = _sites()
    reals = [getattr(m, a) for m, a, _ in sites]

    def wrap(real, kind):
        def call(*args, **kw):
            if kind == "k8":
                table, idx = args[0], args[1]
                calls.append(("k8", {"M": int(idx.shape[0]), "W": int(table.shape[1]),
                                     "R": int(table.shape[0]),
                                     "itemsize": table.element_size()}))
            else:
                rows, upd, n_rows = args[0], args[1], int(args[2])
                M, W = upd.shape
                variant = kw.get("variant") or sc.pick_scatter_variant(
                    M, W, n_rows, upd.element_size(), upd.data_ptr() % 16 == 0,
                    kw.get("spread", False))
                calls.append(("k1", {"M": int(M), "W": int(W), "R": n_rows,
                                     "itemsize": upd.element_size(), "variant": variant}))
            with record_function(f"pb::{kind}"):
                return real(*args, **kw)

        return call

    for (m, a, kind), real in zip(sites, reals):
        setattr(m, a, wrap(real, kind))
    try:
        yield calls
    finally:
        for (m, a, _), real in zip(sites, reals):
            setattr(m, a, real)
