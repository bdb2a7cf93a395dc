"""The port's package surface against the reference's.

For every reference package that the port has a counterpart of, each name
in the reference's ``__all__`` must resolve in the port's package, unless
``NOT_YET_PORTED`` names the ``ROADMAP.md`` queue-1 item that ports it.
That dict only shrinks: a name on it that resolves fails the test, so a
slice that ports a name also takes it off the list. The port keeps its own
``__all__`` lists, which name exactly what it re-exports of the reference's.
"""

import importlib

import pytest

# The packages re-export the function ``policy``, which shadows the module.
jpolicy = importlib.import_module("tpu_dist.models.policy")
tpolicy = importlib.import_module("tpu_dist_torch.models.policy")

PACKAGES = ("", "ops", "serve", "training", "observe", "models", "data",
            "parallel", "cluster", "resilience", "jobs", "analysis")

#: Reference names the port does not have yet -> the ROADMAP.md queue-1
#: item (or decision) that covers them.
NOT_YET_PORTED = {
    "OptaxWrapper": "not ported, by decision (optax has no PyTorch "
                    "counterpart)",
    "check_jaxpr": "not ported, by decision (PyTorch has no jaxpr): "
                   "check_trace checks a recorded entry point",
    "analyze_jaxpr": "not ported, by decision (PyTorch has no jaxpr): "
                     "analyze_trace prices a recorded entry point",
}


def _pair(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module("tpu_dist" + suffix),
            importlib.import_module("tpu_dist_torch" + suffix))


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_reference_names_resolve_in_the_port(sub):
    ref, port = _pair(sub)
    missing = [n for n in ref.__all__
               if n not in NOT_YET_PORTED and not hasattr(port, n)]
    assert missing == [], f"ported names not exported: {missing}"
    stale = [n for n in ref.__all__
             if n in NOT_YET_PORTED and hasattr(port, n)]
    assert stale == [], f"ported now; take them off NOT_YET_PORTED: {stale}"


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_port_all_names_what_it_exports_of_the_reference(sub):
    ref, port = _pair(sub)
    assert all(hasattr(port, n) for n in port.__all__)
    want = {n for n in ref.__all__ if n not in NOT_YET_PORTED}
    assert want <= set(port.__all__), sorted(want - set(port.__all__))


def test_not_yet_ported_names_are_reference_names():
    names = {n for sub in PACKAGES for n in _pair(sub)[0].__all__}
    assert set(NOT_YET_PORTED) <= names, sorted(set(NOT_YET_PORTED) - names)


def test_policy_name_follows_set_policy_as_in_the_reference():
    before = jpolicy.policy(), tpolicy.policy()
    try:
        for name in ("mixed_bfloat16", "bfloat16", "float32"):
            jpolicy.set_policy(name)
            tpolicy.set_policy(name)
            assert tpolicy.policy() == jpolicy.policy() == name
        with pytest.raises(ValueError, match="unknown policy"):
            tpolicy.set_policy("float16")
        assert tpolicy.policy() == jpolicy.policy()
    finally:
        jpolicy.set_policy(before[0])
        tpolicy.set_policy(before[1])


#: Modules whose public names the port keeps one for one.
MODULES = ("serve.fleet", "observe.exporters", "observe.straggler",
           "observe.telemetry", "observe.cli")


@pytest.mark.parametrize("sub", MODULES)
def test_module_public_names_match_the_reference(sub):
    ref = importlib.import_module(f"tpu_dist.{sub}")
    port = importlib.import_module(f"tpu_dist_torch.{sub}")
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items() if not n.startswith("_")
        and getattr(v, "__module__", ref.__name__) == ref.__name__
        and not isinstance(v, type(importlib))]
    assert [n for n in names if not hasattr(port, n)] == []
    if hasattr(ref, "__all__"):
        assert port.__all__ == ref.__all__
