"""The 95th percentile of one generated token's wall over every token of
every request in the window: from the decode step's call to the next
step's call, which follows the token's read-back on the host (the
``greedy_decode`` loop).  Nothing where the entry point returns no token
before the request ends."""
import statistics

#: the fewest walls a 95th percentile is read from: ten beyond it
FEWEST = 200


def read(run):
    walls = [w for s in run.served for w in s.token_walls_ms]
    if len(walls) < FEWEST:
        return None
    return statistics.quantiles(walls, n=20)[-1]
