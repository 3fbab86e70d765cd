"""The benchmark's cells cut to a size the CPU runs in a moment: the
cells' own files, with the widths, the traffic and the check shrunk (each
cut width listed in ``reduced``), for the tests."""
import copy

from bench import harness

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128,
        "vocab": 256}


def tiny(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["model"].update(TINY)
    c["vocab_ids"] = 250
    if c["driver"] == "serve_generate":
        c["model"]["n_kv"] = TINY["n_heads"]
        c["reduced"] = sorted(TINY) + ["n_kv"]
        mix = dict(cell.mix, batch=4, prompt_len=[8, 8], gen_len=[6, 6])
        check = {"requests": 2, "sequences": 2}
    else:
        # wide enough that the planner shards heads (OutC) over the nodes
        c["model"].update(d_model=256, d_ff=1024)
        c["reduced"] = sorted(TINY)
        c["page_size"] = 4
        mix = dict(cell.mix, prompt_len=[8, 12], gen_len=[4, 6], sizes=4,
                   capacity=32)
        check = {"requests": 2}
    spec = dict(cell.spec, check=check,
                trace={"request": 1, "last_steps": 4})
    return harness.Cell(cell.name, cell.entry, c, mix, spec, cell.metrics)


def run(name: str, seed: int = 2**31 + 12345, requests: int = 2,
        cell=None):
    """A run of the tiny cell on the CPU, the harness's look for a chip
    skipped, its window the first ``requests`` requests."""
    import time

    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(cell or tiny(name), seed, 0.0, False, "cpu",
                                time.perf_counter(), requests=requests)
    finally:
        torch.set_num_threads(threads)
