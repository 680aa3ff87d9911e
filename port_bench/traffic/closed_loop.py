"""closed_loop: a fixed pool of clients, each sending its next request when
the previous one completes.  Requests come in rounds of one a client;
every round holds the same stratified sizes (the quantiles ``(i + 0.5) /
clients`` of the length distributions), dealt to the clients in an order
drawn from the seed.  Optional ``shared_prefix`` tokens begin every
prompt."""

from __future__ import annotations

from port_bench.traffic.generator import Request, quantiles, rng


def requests(spec: dict, seed: int, vocab: int) -> list[list[Request]]:
    """Per client, its requests in the order it sends them."""
    clients, rounds = int(spec["clients"]), int(spec["requests_per_client"])
    plens = quantiles(spec["prompt_len"], clients)
    olens = quantiles(spec["output_len"], clients)
    order = rng(seed, 1)
    toks = rng(seed, 2)
    prefix = toks.integers(0, vocab, int(spec.get("shared_prefix", 0))).tolist()
    out = [[] for _ in range(clients)]
    for r in range(rounds):
        pp, oo = order.permutation(clients), order.permutation(clients)
        for c in range(clients):
            n = plens[pp[c]] - len(prefix)
            prompt = prefix + toks.integers(0, vocab, n).tolist()
            out[c].append(Request(c, r, prompt, olens[oo[c]]))
    return out


class Arrivals:
    """Every client's first request at the start; then a client's next
    request as soon as its last one is done; nothing on a timer."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.queues = requests(spec, seed, vocab)

    def start(self) -> list[Request]:
        return [q[0] for q in self.queues]

    def after(self, done: Request, elapsed: float) -> list[Request]:
        q = self.queues[done.client]
        if done.round + 1 >= len(q):
            raise RuntimeError(f"client {done.client} ran out of requests: the traffic "
                               "file's requests_per_client is too small for the window")
        return [q[done.round + 1]]

    def due(self, elapsed: float) -> list[Request]:
        return []
