"""One module a program entry point, named by a configuration's
``driver``: its ``Driver`` sets the entry point up from the
configuration, the traffic mix and the seed, and serves requests through
it (see ``bench/harness.py`` for the protocol)."""
