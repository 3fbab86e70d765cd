"""Tokens the model's step processed in the window over the window's time:
every position of every sequence of every request the window took (the
prompt goes through the decode step too), from the first request's start
to the last one's end, on the host clock."""


def read(run):
    return sum(s.tokens for s in run.served) / run.window_s
