"""The port's checkpoint engine against the JAX package's, on the CPU.

``ray_tpu_torch.checkpoint`` (manager, async writer) and
``air.ShardedCheckpoint`` run the scenarios of
``tests/test_checkpoint_engine.py`` that need no cluster, each on both
packages; the same state gives byte-identical files on both sides (the
two manifests apart from their timestamps), and each side restores the
other's directory. Then the port's trainers: save, step, restore, step
equals the uninterrupted run bit for bit (GPT-2 tiny with dropout, the
ResNet trainer's batch-norm statistics, the pipelined trainer), the
snapshot is taken before an in-place step, and one gloo spawn of 2
ranks saves at fsdp 2 (and pp 2) for a restore on one device within
the mesh tests' f32 tolerance (``dryrun.LOSS_REL``).
"""

import json
import os
import threading
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.air import checkpoint as j_air
from ray_tpu.checkpoint import async_checkpointer as j_ac
from ray_tpu.checkpoint import manager as j_mgr
from ray_tpu_torch.air import checkpoint as t_air
from ray_tpu_torch.checkpoint import async_checkpointer as t_ac
from ray_tpu_torch.checkpoint import manager as t_mgr
from ray_tpu_torch.parallel import dryrun
from ray_tpu_torch.train import spmd


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Side(types.SimpleNamespace):
    """One package's checkpoint API, with its way of turning on the
    checksum verification (JAX: ``RTPU_CKPT_VERIFY=1``; the port: the
    manager's ``verify``)."""

    def verifying(self, mgr, monkeypatch):
        if self.name == "jax":
            monkeypatch.setenv("RTPU_CKPT_VERIFY", "1")
        else:
            mgr.verify = True


SIDES = {
    "jax": _Side(name="jax", Checkpoint=j_air.Checkpoint,
                 Sharded=j_air.ShardedCheckpoint,
                 Manager=j_mgr.CheckpointManager,
                 Async=j_ac.AsyncCheckpointer, ac=j_ac,
                 Pending=j_mgr.PendingCheckpoint),
    "port": _Side(name="port", Checkpoint=t_air.Checkpoint,
                  Sharded=t_air.ShardedCheckpoint,
                  Manager=t_mgr.CheckpointManager,
                  Async=t_ac.AsyncCheckpointer, ac=t_ac,
                  Pending=t_mgr.PendingCheckpoint),
}


@pytest.fixture(params=["jax", "port"])
def side(request):
    return SIDES[request.param]


def _state(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal(n).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)},
            "step": np.asarray(seed, np.int32)}


# ------------------------------------------- test_checkpoint_engine's


def test_atomic_commit_layout_and_load(side, tmp_path):
    mgr = side.Manager(str(tmp_path / "root"))
    for step in range(3):
        mgr.stage(step, side.Checkpoint.from_dict({"step": step}))
        mgr.commit_step(step)
    assert mgr.committed_steps() == [0, 1, 2]
    assert mgr.latest_committed() == 2
    sdir = mgr.step_dir(2)
    assert os.path.exists(os.path.join(sdir, "COMMIT"))
    with open(os.path.join(sdir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["files"]["checkpoint.pkl"]["bytes"] > 0
    assert mgr.load().to_dict() == {"step": 2}
    assert mgr.load(1).to_dict() == {"step": 1}


def test_latest_committed_skips_partial_and_uncommitted(side, tmp_path):
    mgr = side.Manager(str(tmp_path / "root"))
    mgr.stage(1, side.Checkpoint.from_dict({"step": 1}))
    mgr.commit_step(1)
    tmp2 = mgr.begin_step(2)              # died mid-write
    with open(os.path.join(tmp2, "half_written.npy"), "wb") as f:
        f.write(b"\x00" * 128)
    os.makedirs(mgr.step_dir(3))          # died between rename and COMMIT
    with open(os.path.join(mgr.step_dir(3), "checkpoint.pkl"), "wb") as f:
        f.write(b"torn")
    assert mgr.latest_committed() == 1
    assert mgr.load().to_dict() == {"step": 1}
    with pytest.raises(FileNotFoundError):
        mgr.load(3)


def test_checksum_mismatch_detection(side, tmp_path, monkeypatch):
    mgr = side.Manager(str(tmp_path / "root"))
    for step in (1, 2):
        mgr.stage(step, side.Checkpoint.from_dict({"step": step}))
        mgr.commit_step(step)
    victim = os.path.join(mgr.step_dir(2), "checkpoint.pkl")
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\xff\xff")
    assert mgr.verify_step(1) and not mgr.verify_step(2)
    assert mgr.latest_committed() == 2     # not verified: still resolves
    side.verifying(mgr, monkeypatch)
    assert mgr.latest_committed() == 1
    with pytest.raises(FileNotFoundError):
        mgr.load(2)


def test_verify_and_fsync_are_keywords(tmp_path):
    """The port's knobs: ``verify=True`` as the JAX package's
    RTPU_CKPT_VERIFY=1, ``fsync=False`` as RTPU_CKPT_FSYNC=0 (no fsync
    call at all)."""
    mgr = t_mgr.CheckpointManager(str(tmp_path / "a"), verify=True)
    assert mgr.verify and mgr.fsync
    calls = []
    orig = t_mgr.fsync_path
    t_mgr.fsync_path = calls.append
    try:
        quiet = t_mgr.CheckpointManager(str(tmp_path / "b"), fsync=False)
        quiet.stage(0, t_air.Checkpoint.from_dict({"x": 1}))
        quiet.commit_step(0)
        assert calls == []
        mgr.stage(0, t_air.Checkpoint.from_dict({"x": 1}))
        mgr.commit_step(0)
        assert len(calls) >= 5 and mgr.latest_committed() == 0
    finally:
        t_mgr.fsync_path = orig


@pytest.mark.parametrize("name", ["jax", "port"])
def test_retention(name, tmp_path):
    """num_to_keep and keep_every_k, then the same from a config object
    (JAX: its CheckpointConfig; the port reads any object's fields)."""
    from ray_tpu.air.config import CheckpointConfig
    side = SIDES[name]
    mgr = side.Manager(str(tmp_path / "a"), num_to_keep=2, keep_every_k=3)
    for step in range(7):
        mgr.stage(step, side.Checkpoint.from_dict({"step": step}))
        mgr.commit_step(step)
    assert mgr.committed_steps() == [0, 3, 5, 6]
    cfg = (CheckpointConfig(num_to_keep=1, keep_every_k=0) if name == "jax"
           else types.SimpleNamespace(num_to_keep=1, keep_every_k=0))
    mgr = side.Manager(str(tmp_path / "b"), checkpoint_config=cfg)
    for step in range(3):
        mgr.stage(step, side.Checkpoint.from_dict({"step": step}))
        mgr.commit_step(step)
    assert mgr.committed_steps() == [2]


def test_async_save_commit_restore_and_stats(side, tmp_path):
    mgr = side.Manager(str(tmp_path / "root"), num_to_keep=2)
    ck = side.Async(mgr)
    for step in range(3):
        pending = ck.save(step, _state(step))
        assert isinstance(pending, side.Pending) and pending.step == step
    ck.finalize()
    assert mgr.latest_committed() == 2
    assert mgr.committed_steps() == [1, 2]
    restored = mgr.restore_state(_state(99))
    np.testing.assert_array_equal(restored["params"]["w"],
                                  _state(2)["params"]["w"])
    assert int(restored["step"]) == 2
    assert len(ck.stats) == 3
    for st in ck.stats:
        assert st.error is None and st.committed
        assert st.bytes > 0 and st.files > 0 and st.write_ms > 0
        assert st.blocked_ms <= st.snapshot_ms + st.backpressure_ms + 50
    assert ck.stats_summary()["saves"] == 3


def test_kill_mid_write_previous_step_survives(side, tmp_path, monkeypatch):
    mgr = side.Manager(str(tmp_path / "root"))
    ck = side.Async(mgr)
    ck.save(0, _state(0))
    ck.wait()
    real_write = side.ac.write_host_snapshot

    def dying_write(pdir, entries):
        real_write(pdir, entries[: len(entries) // 2])
        raise OSError("killed mid-write")

    monkeypatch.setattr(side.ac, "write_host_snapshot", dying_write)
    ck.save(1, _state(1))
    with pytest.raises(RuntimeError, match="killed mid-write"):
        ck.wait()
    assert mgr.latest_committed() == 0
    assert os.path.isdir(mgr.tmp_dir(1))
    np.testing.assert_array_equal(
        mgr.restore_state(_state(9))["params"]["w"], _state(0)["params"]["w"])
    monkeypatch.setattr(side.ac, "write_host_snapshot", real_write)
    ck.save(2, _state(2))
    ck.finalize()
    assert mgr.latest_committed() == 2
    assert not os.path.isdir(mgr.tmp_dir(1))


def test_backpressure_single_inflight(side, tmp_path, monkeypatch):
    mgr = side.Manager(str(tmp_path / "root"))
    ck = side.Async(mgr)
    real_write = side.ac.write_host_snapshot
    gate = threading.Event()

    def slow_write(pdir, entries):
        gate.wait(5.0)
        return real_write(pdir, entries)

    monkeypatch.setattr(side.ac, "write_host_snapshot", slow_write)
    ck.save(0, _state(0))
    t0 = time.perf_counter()
    releaser = threading.Timer(0.3, gate.set)
    releaser.start()
    ck.save(1, _state(1))
    waited = time.perf_counter() - t0
    ck.finalize()
    releaser.cancel()
    assert waited >= 0.25 and ck.stats[1].backpressure_ms >= 200
    assert mgr.latest_committed() == 1


def test_restore_onto_different_process_count(side, tmp_path):
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    mgr = side.Manager(str(tmp_path / "root"))
    tmp = mgr.begin_step(0)
    for pidx, sl in ((0, slice(0, 4)), (1, slice(4, 8))):
        entries = [{"key": "params/w", "data": full[sl],
                    "index": [[sl.start, sl.stop, None],
                              [None, None, None]],
                    "shape": list(full.shape), "dtype": "float32"}]
        if pidx == 0:
            entries.append({"key": "step", "data": np.asarray(7, np.int32),
                            "index": None, "shape": [], "dtype": "int32"})
        side.ac.write_host_snapshot(os.path.join(tmp, f"process_{pidx}"),
                                    entries)
    mgr.commit_step(0)
    restored = mgr.restore_state({"params": {"w": np.zeros_like(full)},
                                  "step": np.asarray(0, np.int32)})
    np.testing.assert_array_equal(restored["params"]["w"], full)
    assert int(restored["step"]) == 7


def test_to_dict_on_sharded_directory(side, tmp_path):
    root = tmp_path / "ckpt"
    (root / "process_0").mkdir(parents=True)
    (root / "process_0" / "manifest.json").write_bytes(b"[]")
    (root / "meta.txt").write_bytes(b"hello")
    out = side.Checkpoint.from_directory(str(root)).to_dict()
    assert out == {"meta.txt": b"hello",
                   os.path.join("process_0", "manifest.json"): b"[]"}


def test_to_directory_crash_safe(side, tmp_path, monkeypatch):
    import pickle
    dst = str(tmp_path / "out")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(pickle, "dump", boom)
    with pytest.raises(OSError):
        side.Checkpoint.from_dict({"x": 1}).to_directory(dst)
    monkeypatch.undo()
    assert not os.path.exists(dst)
    assert [n for n in os.listdir(tmp_path) if n.startswith(".out")] == []
    assert side.Checkpoint.from_dict({"x": 1}).to_directory(dst) == dst
    side.Checkpoint.from_dict({"x": 2}).to_directory(dst)
    assert side.Checkpoint.from_directory(dst).to_dict() == {"x": 2}


def test_deterministic_shard_filenames(side, tmp_path):
    state = {"layer/0": {"w": np.ones((2, 2), np.float32)},
             "b": np.zeros(3, np.float32)}
    r1, r2 = str(tmp_path / "a"), str(tmp_path / "b")
    side.Sharded(r1).save(state, process_index=0)
    side.Sharded(r2).save(state, process_index=0)
    n1 = sorted(os.listdir(os.path.join(r1, "process_0")))
    assert n1 == sorted(os.listdir(os.path.join(r2, "process_0")))
    assert "b__full.npy" in n1 and "layer_0_w__full.npy" in n1


def test_checkpoint_dict_helpers_and_object_refs():
    ck = t_air.Checkpoint.from_dict({"a": 1}).with_preprocessor({"scale": 2})
    assert ck.get("a") == 1 and ck.get("zz", 5) == 5
    assert ck.get_preprocessor() == {"scale": 2}
    # the JAX package reads what the port attached (and back)
    j = j_air.Checkpoint.from_dict(ck.to_dict())
    assert j.get_preprocessor() == {"scale": 2}
    back = t_air.Checkpoint.from_dict(
        j_air.Checkpoint.from_dict({}).with_preprocessor([1]).to_dict())
    assert back.get_preprocessor() == [1]
    # the object-ref round trip on a port cluster (ray_tpu/air/
    # checkpoint.py:39-42, :94-99): a dict checkpoint and a directory one
    # (put as its dict), read back by the driver and by a task, against
    # the JAX Checkpoint's dict of the same data
    import tempfile

    import ray_tpu_torch as rt
    data = {"step": 3, "w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "t": torch.arange(4, dtype=torch.bfloat16)}
    want = j_air.Checkpoint.from_dict(dict(data)).with_preprocessor(
        {"scale": 2}).to_dict()
    ck = t_air.Checkpoint.from_dict(dict(data)).with_preprocessor(
        {"scale": 2})
    started = not rt.is_initialized()
    if started:
        rt.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        def read_back(refs):
            # in a list: a top-level ref argument arrives resolved
            from ray_tpu_torch.air.checkpoint import Checkpoint
            return Checkpoint.from_object_ref(refs[0]).to_dict()

        with tempfile.TemporaryDirectory() as d:
            from_dir = t_air.Checkpoint.from_directory(ck.to_directory(d))
            refs = [ck.to_object_ref(), from_dir.to_object_ref()]
        for ref in refs:
            for got in (t_air.Checkpoint.from_object_ref(ref).to_dict(),
                        rt.get(rt.remote(read_back).remote([ref]),
                               timeout=120)):
                assert got.keys() == want.keys()
                assert got["step"] == want["step"] == 3
                np.testing.assert_array_equal(got["w"], want["w"])
                assert torch.equal(got["t"], want["t"])
                assert t_air.Checkpoint.from_dict(got).get_preprocessor() \
                    == j_air.Checkpoint.from_dict(want).get_preprocessor()
    finally:
        if started:
            rt.shutdown()


# ------------------------------------------------- format parity


def _mixed_tree(side):
    """An f32, an int32, a Python scalar and a bf16 leaf (numpy's
    ml_dtypes bfloat16 for JAX; a torch bfloat16 tensor for the port,
    the same bits), plus a list."""
    rng = np.random.default_rng(3)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    bf_leaf = (bf if side == "jax" else
               torch.from_numpy(bf.view(np.int16).copy()).view(
                   torch.bfloat16))
    return {"params": {"kernel": rng.standard_normal((4, 6)).astype(
                np.float32), "emb": bf_leaf},
            "ids": rng.integers(0, 9, (7,)).astype(np.int32),
            "lr": 3.5, "hist": [np.float32(1.25), np.arange(3, dtype=np.int64)]}


def _save_both(tmp_path):
    roots = {}
    for name, side in SIDES.items():
        mgr = side.Manager(str(tmp_path / name))
        ck = side.Async(mgr)
        ck.save(3, _mixed_tree(name), metadata={"run": "parity"})
        ck.finalize()
        roots[name] = mgr.step_dir(3)
    return roots


def test_same_state_same_files_on_both_sides(tmp_path):
    roots = _save_both(tmp_path)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert files(roots["jax"]) == files(roots["port"])
    for rel in files(roots["jax"]):
        a, b = (open(os.path.join(roots[s], rel), "rb").read()
                for s in ("jax", "port"))
        if rel in ("MANIFEST.json", "COMMIT"):
            ja, jb = json.loads(a), json.loads(b)
            for d in (ja, jb):
                d.pop("committed_unix", None)
                d.pop("unix", None)
            assert ja == jb, rel
        else:
            assert a == b, rel
    with open(os.path.join(roots["port"], "process_0", "manifest.json")) as f:
        manifest = {e["key"]: e for e in json.load(f)}
    assert manifest["params/emb"]["dtype"] == "bfloat16"
    assert manifest["lr"]["dtype"] == "float64"


def test_each_side_restores_the_others_directory(tmp_path):
    roots = _save_both(tmp_path)
    want_bits = _mixed_tree("jax")["params"]["emb"].view(np.uint16)
    for writer, reader in (("jax", "port"), ("port", "jax")):
        out = SIDES[reader].Sharded(os.path.join(roots[writer])).restore(
            _mixed_tree(reader))
        ref = _mixed_tree(reader)
        np.testing.assert_array_equal(out["params"]["kernel"],
                                      ref["params"]["kernel"])
        np.testing.assert_array_equal(out["ids"], ref["ids"])
        assert out["ids"].dtype == np.int32
        assert float(out["lr"]) == 3.5 and float(out["hist"][0]) == 1.25
        np.testing.assert_array_equal(out["hist"][1], np.arange(3))
        emb = out["params"]["emb"]
        # the port gives a torch bfloat16 tensor; the JAX package the
        # raw 2-byte values numpy reads from '<V2'
        bits = (emb.view(torch.int16).numpy().view(np.uint16)
                if reader == "port" else np.asarray(emb).view(np.uint16))
        np.testing.assert_array_equal(bits, want_bits)
        if reader == "port":
            assert emb.dtype == torch.bfloat16 and emb.shape == (3, 5)


# ------------------------------------------------------- the trainers


def _tiny_gpt2(**kw):
    import dataclasses

    from ray_tpu_torch.models.gpt2 import GPT2Config
    return dataclasses.replace(GPT2Config.tiny(), **kw)


def _metrics(trainer, state, batches):
    out = []
    for b in batches:
        state, m = trainer.step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return out


def _lm_batches(trainer, n, vocab, shape=(2, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [spmd.put_batch(trainer, {"input_ids": t, "labels": t})
            for t in (rng.integers(0, vocab, shape) for _ in range(n))]


def _same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b) and a.dtype == b.dtype
    return a == b


def _assert_state_equal(want, got):
    assert set(want["model"]) == set(got["model"])
    for n in want["model"]:
        assert _same(want["model"][n], got["model"][n]), n
    assert set(want["opt"]) == set(got["opt"])
    for n, st in want["opt"].items():
        assert set(st) == set(got["opt"][n]), n
        for k in st:
            assert _same(st[k], got["opt"][n][k]), (n, k)


def test_gpt2_save_restore_resume_is_exact_with_dropout(tmp_path):
    """Save after 2 steps, 2 more steps; a fresh init from another seed
    restored by restore_spmd_state runs the same 2 batches bit for bit
    (dropout's stream follows the restored step); the restored state
    equals the saved one exactly. Without a manager or a checkpoint,
    outside a train session, both calls raise: there is no session to
    bind to."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    tr = spmd.make_causal_lm_trainer(_tiny_gpt2(dropout=0.1), device="cpu")
    batches = _lm_batches(tr, 4, 512)
    state = tr.init(0)
    _metrics(tr, state, batches[:2])
    saved = spmd.gather_state(state)
    mgr = CheckpointManager(str(tmp_path / "run"), num_to_keep=2)
    ck = spmd.make_async_checkpointer(manager=mgr)
    ck.save(state["step"], state)
    ref = _metrics(tr, state, batches[2:])
    ck.finalize()
    fresh = tr.init(7)
    assert not fresh["opt"].state           # AdamW's state is lazy
    restored = spmd.restore_spmd_state(fresh, manager=mgr)
    assert restored is fresh and restored["step"] == 2
    _assert_state_equal(saved, spmd.gather_state(restored))
    assert _metrics(tr, restored, batches[2:]) == ref
    # a directory Checkpoint works the same way
    again = spmd.restore_spmd_state(tr.init(3), checkpoint=mgr.load())
    _assert_state_equal(saved, spmd.gather_state(again))
    with pytest.raises(ValueError, match="needs a CheckpointManager"):
        spmd.restore_spmd_state(tr.init(3))
    with pytest.raises(RuntimeError, match="no checkpoint manager in the "
                                           "session"):
        spmd.make_async_checkpointer()


def test_snapshot_precedes_in_place_step(tmp_path, monkeypatch):
    """AdamW steps params and moments in place: a save whose write is
    held back until after the next step still restores the values at
    the save (the snapshot copies, never aliases)."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    tr = spmd.make_causal_lm_trainer(_tiny_gpt2(), device="cpu")
    batches = _lm_batches(tr, 2, 512, seed=1)
    state = tr.init(0)
    _metrics(tr, state, batches[:1])
    saved = spmd.gather_state(state)
    gate = threading.Event()
    real = t_ac.write_host_snapshot

    def held(pdir, entries):
        gate.wait(10.0)
        return real(pdir, entries)

    monkeypatch.setattr(t_ac, "write_host_snapshot", held)
    mgr = CheckpointManager(str(tmp_path / "run"))
    ck = spmd.make_async_checkpointer(manager=mgr)
    ck.save(state["step"], state)
    _metrics(tr, state, batches[1:])        # in place, write held
    gate.set()
    ck.finalize()
    moved = spmd.gather_state(state)
    assert not torch.equal(moved["model"]["wte.weight"],
                           saved["model"]["wte.weight"])
    _assert_state_equal(saved, spmd.gather_state(
        spmd.restore_spmd_state(tr.init(5), manager=mgr)))


def test_resnet_batch_norm_statistics_come_back(tmp_path):
    """The image trainer: batch-norm running statistics (buffers) and
    SGD's momentum come back, and the next step matches."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    from ray_tpu_torch.models.resnet import ResNet, ResNetBlock
    model = ResNet(stage_sizes=[1, 1], block_cls=ResNetBlock, num_classes=5,
                   num_filters=8, dtype=torch.float32, small_images=True)
    tr = spmd.make_image_classifier_trainer(model, input_shape=(1, 16, 16, 3),
                                            device="cpu")
    rng = np.random.default_rng(2)
    batches = [spmd.put_batch(tr, {
        "image": rng.integers(0, 255, (4, 16, 16, 3), dtype=np.uint8),
        "label": rng.integers(0, 5, (4,))}) for _ in range(2)]
    state = tr.init(0)
    _metrics(tr, state, batches[:1])
    saved = spmd.gather_state(state)
    assert any("running_mean" in n for n in saved["model"])
    mgr = CheckpointManager(str(tmp_path / "run"))
    spmd.make_async_checkpointer(manager=mgr, async_=False).save(1, state)
    ref = _metrics(tr, state, batches[1:])
    restored = spmd.restore_spmd_state(tr.init(4), manager=mgr)
    _assert_state_equal(saved, spmd.gather_state(restored))
    assert _metrics(tr, restored, batches[1:]) == ref


def test_pipelined_trainer_resumes_at_pp1(tmp_path):
    """The pipelined trainer's stages are saved stacked ([pp, ...]); at
    pp 1 on one device the restore resumes bit for bit (pp 2 runs in
    the spawn below)."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    tr = spmd.make_pipelined_lm_trainer(_tiny_gpt2(), device="cpu")
    batches = _lm_batches(tr, 3, 512, shape=(2, 2, 16), seed=4)
    state = tr.init(0)
    _metrics(tr, state, batches[:1])
    mgr = CheckpointManager(str(tmp_path / "run"))
    spmd.make_async_checkpointer(manager=mgr, async_=False).save(1, state)
    with open(os.path.join(mgr.step_dir(1), "process_0",
                           "manifest.json")) as f:
        shapes = {e["key"]: e["shape"] for e in json.load(f)}
    w = state["mesh_state"].shards["stages.h_0.attn.c_attn.weight"]
    assert shapes["model/stages.h_0.attn.c_attn.weight"] == [1, *w.shape]
    ref = _metrics(tr, state, batches[1:])
    restored = spmd.restore_spmd_state(tr.init(6), manager=mgr)
    assert _metrics(tr, restored, batches[1:]) == ref


def test_mesh_checkpoints_restore_on_one_device(tmp_path):
    """One spawn of 2 gloo ranks: (a) GPT-2 tiny at fsdp 2 saves after
    one step (each rank its blocks, rank 0 commits after a barrier),
    then steps on; restored here on one device, the next step's loss
    and grad norm equal the 2-rank run's within LOSS_REL and the state
    equals the gathered one at the save; (b) the pipelined trainer at
    pp 2 saves, steps, and a fresh init restored at pp 2 repeats that
    step bit for bit."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    root = str(tmp_path / "ckpt")
    ranks = dryrun.spawn(dryrun.call_all, 2, args=([
        ("ray_tpu_torch.parallel.dryrun", "checkpoint_case",
         {"kind": "causal_lm", "root": os.path.join(root, "fsdp"),
          "spec": {"fsdp": 2}}),
        ("ray_tpu_torch.parallel.dryrun", "checkpoint_case",
         {"kind": "pipelined", "root": os.path.join(root, "pp"),
          "spec": {"pp": 2}})],), timeout_s=120.0)
    fsdp, pp = zip(*ranks)
    for r in pp:
        assert r["resumed"] == r["metrics"][1:]
    rank0 = fsdp[0]
    assert fsdp[1]["metrics"] == rank0["metrics"]
    mgr = CheckpointManager(os.path.join(root, "fsdp"))
    assert mgr.committed_steps() == [1]
    names = sorted(os.listdir(mgr.step_dir(1)))
    assert names == ["COMMIT", "MANIFEST.json", "process_0", "process_1"]
    tr = spmd.make_causal_lm_trainer(_tiny_gpt2(), device="cpu")
    restored = spmd.restore_spmd_state(tr.init(9), manager=mgr)
    got = spmd.gather_state(restored)
    for n, v in rank0["saved"]["model"].items():
        np.testing.assert_array_equal(got["model"][n].numpy(), v)
    for n, st in rank0["saved"]["opt"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(np.asarray(got["opt"][n][k]),
                                          np.asarray(v))
    batch = spmd.put_batch(tr, dryrun.checkpoint_batch(512)[1])
    m = _metrics(tr, restored, [batch])[0]
    for k, v in rank0["metrics"][1].items():
        assert abs(m[k] - v) <= dryrun.LOSS_REL * abs(v), (k, m[k], v)


def test_bench_ckpt_loop_on_cpu():
    from ray_tpu_torch import bench
    r = bench.ckpt_loop(device="cpu", saves=1)
    assert r["ckpt_async_blocked_ms_per_save"] < \
        r["ckpt_sync_blocked_ms_per_save"]
    assert r["ckpt_bytes_per_save"] > 0 and r["ckpt_files_per_save"] > 0
    assert 0 < r["ckpt_blocked_frac_vs_sync"] < 1
