"""The FL round's regions (``repro_torch.obs``): what an enabled recorder
sees of ``dist.fl_step``, and that it only observes.

Two rounds of a tiny MoE ``ElasticFLStep`` (2 pods, the int8 torrent,
MoE token blocks of 64 so that each block is checkpointed and its
routing recomputed in the backward) run on the CPU.  The ``cuda`` tests
run the same rounds on the card, where the regions time the stream and
the round counts host syncs and allocator retries.
"""
import gc
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.dist import fl_step  # noqa: E402
from repro_torch.dist.fl_step import ElasticFLStep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import ArchConfig, init_params, layers  # noqa: E402
from repro_torch.obs.recorder import _gc_region  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.schedules import constant_lr  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

PODS = 2
SITES = {"fl.round", "fl.grad", "fl.forward", "fl.backward", "fl.row_write",
         "fl.torrent", "torrent.quantize", "torrent.dequantize",
         "torrent.fedavg", "torrent.unflatten", "fl.mass_sync", "fl.adamw",
         "moe.route"}
PARENT = {"fl.grad": {"fl.round"}, "fl.forward": {"fl.grad"},
          "fl.backward": {"fl.grad"}, "fl.row_write": {"fl.grad"},
          "fl.torrent": {"fl.round"}, "torrent.quantize": {"fl.torrent"},
          "torrent.dequantize": {"fl.torrent"},
          "torrent.fedavg": {"fl.torrent"},
          "torrent.unflatten": {"fl.torrent"},
          "fl.mass_sync": {"fl.round"}, "fl.adamw": {"fl.round"},
          "moe.route": {"fl.forward", "fl.backward"}}
DEVICE_TIMED = {"fl.round", "fl.grad", "fl.forward", "fl.backward",
                "fl.torrent", "fl.adamw"}


def _cfg(**kw):
    arch = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv=2, head_dim=8, d_ff=0, vocab=128, pattern=("moe",),
                n_experts=4, top_k=2, d_expert=16, capacity_factor=1.25,
                dtype="float32", remat=True)
    arch.update(kw)
    return ArchConfig(**arch)


class _Rounds:
    """A tiny FL program: weights, AdamW state, the step, one batch."""

    def __init__(self, device="cpu", cfg=None, seq=64):
        cfg = cfg or _cfg()
        params = init_params(cfg, torch.Generator().manual_seed(0))
        self.params = tree_map(lambda x: x.to(device), params)
        self.opt = adamw_init(self.params)
        self.step = ElasticFLStep(cfg, lr_schedule=constant_lr(1e-3),
                                  mesh_factory=lambda p: None,
                                  torrent_blocks=4, compress=True)
        g = torch.Generator().manual_seed(1)
        shape = (PODS, 2, seq)
        self.batch = {k: torch.randint(0, cfg.vocab, shape,
                                       generator=g).to(device)
                      for k in ("inputs", "labels")}
        self.ones = torch.ones(PODS, device=device)

    def run(self, n=1):
        losses = []
        for _ in range(n):
            self.params, self.opt, m = self.step(
                self.params, self.opt, self.batch, self.ones, self.ones)
            losses.append(m["loss"])
        return losses


@pytest.fixture
def blocks_of_64(monkeypatch):
    monkeypatch.setattr(layers, "MOE_TOKEN_BLOCK", 64)


def _by_round(rows):
    """{round id: the round's rows}, in the order they closed."""
    out = {r["id"]: [] for r in rows if r["name"] == "fl.round"}
    for r in rows:
        out[r["round"]].append(r)
    return out


def _shape(rows):
    names = {r["id"]: r["name"] for r in rows}
    return [(r["name"], names.get(r["parent"])) for r in rows
            if r["name"] != "py.gc"]


def test_two_rounds_record_every_site_with_round_and_parent(blocks_of_64):
    prog = _Rounds()
    with obs.recording(clock=time.perf_counter) as rec:
        prog.run(2)
        rec.resolve()
    rows = rec.rows
    assert [r["seq"] for r in rows] == list(range(len(rows)))
    ids = [r["id"] for r in rows]
    assert len(set(ids)) == len(ids)
    rounds = _by_round(rows)
    assert len(rounds) == 2
    names = {r["id"]: r["name"] for r in rows}
    for rid, rs in rounds.items():
        assert {r["name"] for r in rs} - {"py.gc"} == SITES
        mine = {r["id"] for r in rs}
        for r in rs:
            assert r["kind"] == "span" and r["wall_s"] >= 0
            assert "device_ms" not in r            # no device here
            if r["name"] == "fl.round":
                assert r["id"] == rid and r["parent"] is None
                assert r["host_syncs"] == 0
                assert "alloc_retries" not in r
                continue
            assert r["parent"] in mine
            if r["name"] != "py.gc":
                assert names[r["parent"]] in PARENT[r["name"]], r
        assert sorted(r["pod"] for r in rs if r["name"] == "fl.grad") \
            == list(range(PODS))
        # the routing runs in the forward and again in the backward's
        # recompute of each checkpointed block
        route = [names[r["parent"]] for r in rs if r["name"] == "moe.route"]
        assert route.count("fl.forward") == PODS * 2 * 2
        assert route.count("fl.backward") >= route.count("fl.forward")
    first, second = rounds.values()
    assert _shape(first) == _shape(second)
    assert obs.validate_rows(obs.to_jsonl_rows(rec)) == []


def test_the_recorder_only_observes(blocks_of_64):
    off, on = _Rounds(), _Rounds()
    loss_off = off.run(2)
    with obs.recording(clock=time.perf_counter):
        loss_on = on.run(2)
    for a, b in zip(loss_off, loss_on):
        assert torch.equal(a, b)
    for a, b in zip(leaves((off.params, off.opt)),
                    leaves((on.params, on.opt))):
        assert torch.equal(a, b)


def test_null_recorder_opens_no_annotation_and_no_event(monkeypatch,
                                                         blocks_of_64):
    def refuse(*a, **k):
        raise AssertionError("called under the null recorder")

    prog = _Rounds()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    assert not obs.get().enabled
    assert _gc_region not in gc.callbacks
    prog.run(1)


def test_collections_are_regions_only_while_a_recorder_is_installed(
        monkeypatch):
    def update(*a, **k):
        gc.collect()
        return orig(*a, **k)

    orig = fl_step.adamw_update
    monkeypatch.setattr(fl_step, "adamw_update", update)
    prog = _Rounds()
    with obs.recording() as rec:
        assert _gc_region in gc.callbacks
        gc.collect()                     # no region open: not recorded
        prog.run(1)
    assert _gc_region not in gc.callbacks
    names = {r["id"]: r["name"] for r in rec.rows}
    full = [names[r["parent"]] for r in rec.rows
            if r["name"] == "py.gc" and r["generation"] == 2]
    assert "fl.adamw" in full


def test_a_region_opened_on_another_thread_nests_in_the_open_one():
    """As the autograd engine's device thread runs the backward while
    the caller waits inside ``fl.backward``."""
    with obs.recording() as rec:
        with rec.region("fl.backward"):
            t = threading.Thread(
                target=lambda: rec.region("moe.route").__enter__()
                .__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    inner, outer = rec.rows
    assert (inner["name"], outer["name"]) == ("moe.route", "fl.backward")
    assert inner["parent"] == outer["id"]
    assert rec._open == []


def test_extension_region_only_around_the_load(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(_build, "_ext", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cpp, "load", lambda **kw: "the extension")
    with obs.recording() as rec:
        assert _build.extension() == "the extension"
        assert _build.extension() == "the extension"
    assert [r["name"] for r in rec.rows] == ["kernels.extension"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


class _Sync(torch.autograd.Function):
    """Identity whose backward reads a value on the host: a sync on the
    autograd engine's device thread."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g


def _window(prog, n=2):
    prog.run(1)                          # warm: the extension's load
    with obs.recording() as rec:
        prog.run(n)
        torch.cuda.synchronize()
        rec.resolve()
    return rec.rows


@pytest.mark.cuda
def test_cuda_device_ms_on_every_device_timed_region(blocks_of_64):
    _needs_card()
    rows = _window(_Rounds("cuda"))
    assert {r["name"] for r in rows} >= SITES
    for r in rows:
        if r["name"] in DEVICE_TIMED:
            assert r["device_ms"] > 0, r
        else:
            assert "device_ms" not in r, r
    for r in rows:
        if r["name"] == "fl.round":
            assert r["host_syncs"] >= 1          # the mass check
            assert r["alloc_retries"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["adamw", "backward"])
def test_cuda_a_planted_item_counts_one_more_sync(monkeypatch, site,
                                                  blocks_of_64):
    _needs_card()
    prog = _Rounds("cuda")
    base = [r["host_syncs"] for r in _window(prog)
            if r["name"] == "fl.round"]
    if site == "adamw":                  # on the calling thread
        orig = fl_step.adamw_update

        def planted(agg, *a, **k):
            leaves(agg)[0].sum().item()
            return orig(agg, *a, **k)
        monkeypatch.setattr(fl_step, "adamw_update", planted)
    else:                                # on autograd's device thread
        orig = fl_step.train_loss
        monkeypatch.setattr(fl_step, "train_loss",
                            lambda *a, **k: _Sync.apply(orig(*a, **k)))
    syncs = [r["host_syncs"] for r in _window(prog)
             if r["name"] == "fl.round"]
    assert base[0] == base[1]
    per_pod = PODS if site == "backward" else 1
    assert syncs == [base[0] + per_pod] * 2
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_cuda_a_forced_allocator_retry_is_counted():
    """The cache filled with small blocks, under a limit that leaves the
    round room only once they are released: the round's first large
    allocation fails, every cached block is freed, and the retry
    succeeds."""
    _needs_card()
    prog = _Rounds("cuda", cfg=_cfg(d_model=256, vocab=8192, head_dim=32,
                                    d_expert=256), seq=256)
    prog.run(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    prog.run(1)
    need = torch.cuda.max_memory_reserved() - base
    torch.cuda.empty_cache()
    small = [torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
             for _ in range(need // (1 << 20) + 1)]
    del small                            # cached in the small pool
    limit = torch.cuda.memory_reserved() + need // 2
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        with obs.recording() as rec:
            prog.run(1)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    row, = [r for r in rec.rows if r["name"] == "fl.round"]
    assert row["alloc_retries"] >= 1
