"""The port's block registry (``gr4_packet_modem_tpu_torch/registry.py``):
tests/test_registry.py's cases on it, and its inventory against the JAX
registry's (the same keys in the same order, kinds and reference
headers), every resolved target from the port."""

import pytest

pytest.importorskip("torch")

from gr4_packet_modem_tpu import registry as jregistry  # noqa: E402
from gr4_packet_modem_tpu_torch import registry  # noqa: E402
from test_registry import REFERENCE_HEADERS  # noqa: E402


def test_inventory_covers_every_reference_block():
    covered = {e.reference for e in registry.BLOCK_REGISTRY.values()}
    missing = [h for h in REFERENCE_HEADERS if h not in covered]
    assert not missing, f"uncovered reference blocks: {missing}"


def test_resolvable_entries_import():
    failures = []
    for name, entry in registry.BLOCK_REGISTRY.items():
        if entry.kind == "subsumed":
            continue
        try:
            obj = registry.resolve(name)
            assert obj is not None
            mod = getattr(obj, "__module__", None) or obj.__name__
            assert mod.split(".")[0] == "gr4_packet_modem_tpu_torch", (name, mod)
        except Exception as e:  # noqa: BLE001
            failures.append((name, str(e)))
    assert not failures, failures


def test_subsumed_raises_with_pointer():
    with pytest.raises(KeyError, match="subsumed"):
        registry.resolve("TagGate")


def test_coverage_stats():
    cov = registry.coverage()
    assert sum(cov.values()) == len(registry.BLOCK_REGISTRY)
    assert cov.get("op", 0) >= 20
    assert cov == jregistry.coverage()


def test_keys_kinds_and_headers_equal_jax():
    mine, theirs = registry.BLOCK_REGISTRY, jregistry.BLOCK_REGISTRY
    assert list(mine) == list(theirs)
    assert len(mine) == 72
    for name in theirs:
        assert (mine[name].kind, mine[name].reference) == (theirs[name].kind, theirs[name].reference), name


def test_targets_name_no_jax_tool():
    """Subsumed entries that named a JAX tool name the torch counterpart."""
    for name, e in registry.BLOCK_REGISTRY.items():
        text = f"{e.target} {e.note}"
        assert "jax" not in text and "jnp" not in text, (name, text)
    assert registry.BLOCK_REGISTRY["NullSource"].target == "torch.zeros"


def test_notes_name_the_kernels():
    """Where a target launches a hand-written kernel on CUDA tensors, its
    note names it."""
    notes = {k: registry.BLOCK_REGISTRY[k].note for k in (
        "SyncwordDetection", "HeaderFecDecoder", "PacketReceiver", "CostasLoop", "SymbolFilter")}
    assert "K1" in notes["SyncwordDetection"] and "K2b" in notes["SyncwordDetection"]
    assert "K5" in notes["HeaderFecDecoder"]
    assert all(k in notes["PacketReceiver"] for k in ("K1", "K2", "K2b", "K3", "K4", "K5"))
    assert "K4" in notes["CostasLoop"]
    assert "K2" in notes["SymbolFilter"] and "K3" in notes["SymbolFilter"]
    from gr4_packet_modem_tpu_torch.ops.ldpc import HeaderLdpcDecoder

    assert registry.resolve("HeaderFecDecoder") is HeaderLdpcDecoder
