"""
llh server: serve compiled-template likelihood evaluations over TCP
(cf. reference ``pisa/utils/llh_server.py``: 4-byte big-endian length header
+ pickled payload; clients send rescaled free-param vectors and receive the
scalar llh).

This exists for wire-protocol parity with the reference's emcee workflow.
The compiled path does NOT need it: use
:func:`pisa_tpu.parallel.build_batched_objective` (vmapped walkers, sharded
over the mesh) or :func:`pisa_tpu.analysis.bayesian.mcmc_sampling` — both
evaluate entirely on device without sockets or processes. Unlike the
reference, one server here evaluates the jit-compiled template, so a single
process replaces the reference's CPU server farm.
"""

from __future__ import annotations

import pickle
import socketserver
import struct
from multiprocessing import Process, cpu_count

import numpy as np

__all__ = [
    "ConnectionClosed",
    "send_obj",
    "receive_obj",
    "serve",
    "fork_servers",
    "main",
]

DFLT_HOST = "localhost"
DFLT_PORT = 9000
DFLT_NUM_SERVERS = cpu_count()


class ConnectionClosed(Exception):
    """Connection closed."""


def send_obj(obj, sock):
    """Send a pickled object with a 4-byte big-endian length header
    (cf. reference ``llh_server.py:64``)."""
    payload = pickle.dumps(obj)
    sock.sendall(struct.pack("!i", len(payload)))
    sock.sendall(payload)


def receive_obj(sock):
    """Receive an object framed by :func:`send_obj`
    (cf. reference ``llh_server.py:88``)."""
    header = sock.recv(4)
    if len(header) == 0:
        raise ConnectionClosed()
    (payload_size,) = struct.unpack("!i", header)
    chunks = []
    received = 0
    while received < payload_size:
        chunk = sock.recv(payload_size - received)
        if len(chunk) == 0:
            raise ConnectionClosed()
        chunks.append(chunk)
        received += len(chunk)
    return pickle.loads(b"".join(chunks))


def serve(config, ref, port=DFLT_PORT, metric="llh", host=DFLT_HOST):
    """Run a server evaluating the compiled-template llh of `config`'s
    pipeline(s) against the reference map(s) at `ref`
    (cf. reference ``llh_server.py:serve``). Blocks forever.

    Parameters
    ----------
    config : str or list — pipeline config path(s)
    ref : str or MapSet — reference (data) distribution (json path or MapSet)
    port : int
    metric : str — llh-family metric to serve (sign as maximized llh)
    """
    from pisa_tpu.core.distribution_maker import DistributionMaker
    from pisa_tpu.core.map import MapSet
    from pisa_tpu.utils import stats

    dm = DistributionMaker(
        [config] if isinstance(config, str) else list(config)
    )
    if isinstance(ref, str):
        ref_dist = MapSet.from_json(ref)
    else:
        ref_dist = ref

    # one compiled objective serves all requests (single pipeline case uses
    # the jitted template; multi-pipeline falls back to the eager path)
    sign = -1.0 if not stats.is_metric_to_maximize(metric) else 1.0
    try:
        ct = dm.pipelines[0].compile()
        value_only, _ = ct.build_objective(ref_dist, metric)

        def llh(x):
            # objective is minimized => llh = -objective for llh metrics
            return -float(value_only(np.asarray(x, dtype=np.float64)))

    except Exception:  # multi-pipeline or non-compilable: eager path
        def llh(x):
            dm._set_rescaled_free_params(np.asarray(x, dtype=np.float64))
            hypo = dm.get_outputs(return_sum=True)
            return sign * float(ref_dist.metric_total(hypo, metric))

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    x = receive_obj(self.request)
                except (ConnectionClosed, ConnectionResetError):
                    return
                send_obj(llh(x), self.request)

    server = socketserver.TCPServer((host, int(port)), Handler)
    server.allow_reuse_address = True
    server.serve_forever()


def fork_servers(config, ref, port=DFLT_PORT, num=DFLT_NUM_SERVERS, **kw):
    """Fork `num` server processes on consecutive ports
    (cf. reference ``llh_server.py:fork_servers``). Note: with the compiled
    template a single server usually suffices; this exists for parity."""
    processes = []
    for i in range(num):
        p = Process(
            target=serve,
            kwargs=dict(config=config, ref=ref, port=int(port) + i, **kw),
            daemon=True,
        )
        p.start()
        processes.append(p)
    return processes


def main():
    from argparse import ArgumentParser

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, action="append")
    parser.add_argument("--ref", required=True)
    parser.add_argument("--port", type=int, default=DFLT_PORT)
    parser.add_argument("--metric", default="llh")
    parser.add_argument("--num", type=int, default=1)
    args = parser.parse_args()
    if args.num == 1:
        serve(args.config, args.ref, port=args.port, metric=args.metric)
    else:
        procs = fork_servers(
            args.config, args.ref, port=args.port, num=args.num,
            metric=args.metric,
        )
        for p in procs:
            p.join()


if __name__ == "__main__":
    main()
