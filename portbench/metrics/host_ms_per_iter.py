"""host_ms_per_iter (ms): the scheduler's host time per decode iteration
in which the card runs none of the calls it makes, from the program's own
trace (``repro_torch.serving.tracing``): each ``round`` span before the
profiled stretch, over the rounds' decode iterations, less the host's wait
for the burst (``sync``), its sleeps for arrivals (``await_arrival``), the
time inside ``decode`` outside the program's ``launch`` (a caller's
wrapper around the step: the benchmark's tick probe, which waits for the
card and counts slots), and the part of each span that makes a device
call during which the card runs that call (the host launching or waiting
for it: the benchmark's prefill probe syncs, the prefill's own host reads
wait too). Layer: scheduler (``serving/scheduler.py``)."""
from portbench.metrics._spans import spans

NOT_HOST = ("sync", "await_arrival")


def read(rec: dict):
    sp = spans(rec)
    if sp is None:
        return None
    rounds = {s[3]["id"] for s in sp.named("round")}

    def in_rounds(span):
        r = sp.ancestor(span, "round")
        return r is not None and r[3]["id"] in rounds

    total = sum(s[1] - s[0] for s in sp.named("round"))
    iters = 0
    for s in sp.host:
        if not in_rounds(s):
            continue
        if s[2] in NOT_HOST:
            total -= s[1] - s[0]
        elif s[2] == "decode":
            total -= s[1] - s[0]
            iters += s[3]["horizon"]
        elif s[2] in ("launch", "capture") \
                and sp.by_id[s[3]["parent"]][2] == "decode":
            total += s[1] - s[0]
    for d in sp.device:
        host = sp.by_id.get(d[3]["host"])
        if host is not None and in_rounds(host):
            total -= max(0.0, min(d[1], host[1]) - max(d[0], host[0]))
    return total / 1e3 / iters if iters else None
