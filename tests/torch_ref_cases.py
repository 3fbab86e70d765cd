"""Run the JAX package's own test cases on the port: a reference test
module's source executed again with every import of ``repro`` (and of its
submodules) redirected to ``repro_torch``, so its test functions and
helpers call the port's modules under the reference's assertions."""
import builtins
from pathlib import Path

import repro_torch


def _redirect(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "repro" or name.startswith("repro.")):
        name = "repro_torch" + name[len("repro"):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def port_namespace(ref_module: str, edits=()) -> dict:
    """The globals of ``tests/<ref_module>.py`` executed on the port.  The
    result is a dict, not a module, so pytest collects nothing from it.
    ``edits`` are ``(old, new)`` replacements of the source, each of which
    must occur: where the port's API rightly differs from the reference's
    (a caller states each and why)."""
    path = Path(__file__).with_name(f"{ref_module}.py")
    src = path.read_text()
    for old, new in edits:
        assert old in src, f"{ref_module}.py has no {old!r}"
        src = src.replace(old, new)
    ns = {"__name__": f"{ref_module}_on_the_port", "__file__": str(path),
          "__builtins__": dict(vars(builtins), __import__=_redirect)}
    exec(compile(src, str(path), "exec"), ns)
    leaked = sorted(k for k, v in ns.items()
                    if str(getattr(v, "__module__", "")).startswith("repro.")
                    or getattr(v, "__name__", "") == "repro")
    assert leaked == [], f"reference names in the port's namespace: {leaked}"
    return ns


def reference_cases(ns: dict) -> list:
    return sorted(k for k, v in ns.items()
                  if k.startswith("test_") and callable(v))


def run_case(ns: dict, name: str, request) -> None:
    """Call the case with the pytest fixtures its signature names."""
    import inspect
    fn = ns[name]
    assert fn.__globals__ is ns
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


assert repro_torch.__name__ == "repro_torch"
