#!/usr/bin/env python
"""Mixed-Precision Quantization (reference: examples/cnn_mpq.py).

Counterpart of ``examples/cnn_mpq.py``: MPQ routes each key by size on
the WAN hop. Keys smaller than ``MXNET_KVSTORE_SIZE_LOWER_BOUND``
elements (default 200,000) travel as FP16, larger ones through BSC.
Like BSC mode, aggregation is gradient-only with a local Adam per worker
(``cnn_bsc.train_local_adam``). Every worker runs:

  python -m geomx_tpu_torch.examples.cnn_mpq [--cpu]
"""

from __future__ import annotations

import logging
import os

from geomx_tpu_torch.examples import cnn_bsc


def parse_args(argv=None):
    args = cnn_bsc.make_parser(lr=0.001).parse_args(argv)
    args.size_lower_bound = int(os.getenv("MXNET_KVSTORE_SIZE_LOWER_BOUND",
                                          200000))
    return args


def run_worker(kv, args, device=None, on_round=None):
    """One node's part (see ``cnn.run_worker``): the master sets MPQ on
    the WAN hop and returns None; a party worker returns ``{"leaves",
    "accs", "losses", "step_ms"}``."""
    return cnn_bsc.train_local_adam(
        kv, args, {"type": "mpq", "threshold": args.compression_ratio,
                   "size_lower_bound": args.size_lower_bound},
        "cnn_mpq", device, on_round)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    run_worker(gx.kv.create("dist_sync", device=device), args, device)


if __name__ == "__main__":
    main()
