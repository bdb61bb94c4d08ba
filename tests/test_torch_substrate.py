"""The port's training substrate (on the CPU) against the JAX package's:
the data pipeline, checkpoints, AdamW, one train step, and the trainer
CLI's resume and elastic handoff (the ``train_lm`` example's twin runs in
``tests/test_torch_train_lm.py``).

Mirrors ``tests/test_substrate.py`` on the port and holds each piece
against the reference on the same inputs: batches equal bit for bit; AdamW
on the same gradients within 1e-6 of the reference's state and parameters;
one train step on SMOKE Qwen3 in float32 within 1e-5 (loss, gradient norm)
and 1e-4 of each leaf's largest value (the new parameters: the first steps
move each entry by about lr * g / (|g| + eps), so entries whose gradient is
near eps carry the gradients' 1e-6 differences up); resume and the elastic
handoff bit for bit (tighter than the reference's rel 1e-3).
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import make_pipeline as jmake_pipeline
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_pipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, params_from_jax
from repro_torch.optim import OptConfig, adamw_init, adamw_update, cosine_lr
from test_torch_models import _perturbed_params, _rel, _t


class TestData:
    def test_batches_equal_the_reference_bit_for_bit(self):
        for vocab, seq, batch, seed in ((100, 32, 4, 7), (65536, 64, 3, 0)):
            ours, theirs = make_pipeline(vocab, seq, batch, seed), jmake_pipeline(vocab, seq,
                                                                                   batch, seed)
            for step in (0, 5):
                a, b = ours.batch(step), theirs.batch(step)
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(ours.batch(2, host_slice=(1, 3))["tokens"],
                                          theirs.batch(2, host_slice=(1, 3))["tokens"])

    def test_deterministic_across_instances(self):
        b1, b2 = make_pipeline(100, 32, 4, seed=7).batch(5), make_pipeline(100, 32, 4,
                                                                          seed=7).batch(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = make_pipeline(100, 32, 2, seed=0).batch(0)
        assert b["tokens"].shape == b["labels"].shape == (2, 32)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_slice_matches_global(self):
        pipe = make_pipeline(100, 16, 8, seed=3)
        np.testing.assert_array_equal(pipe.batch(2)["tokens"][2:5],
                                      pipe.batch(2, host_slice=(2, 5))["tokens"])

    def test_different_steps_differ(self):
        pipe = make_pipeline(100, 32, 2, seed=0)
        assert not np.array_equal(pipe.batch(0)["tokens"], pipe.batch(1)["tokens"])


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(10, dtype=torch.float32),
                "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}, "n": np.int32(3)}
        save_checkpoint(tmp_path, 7, tree, extra={"data_step": 7})
        out, step, extra = restore_checkpoint(tmp_path, tree)
        assert step == 7 and extra["data_step"] == 7
        np.testing.assert_array_equal(out["a"].numpy(), np.arange(10))
        assert out["b"]["c"].shape == (3, 4) and out["b"]["c"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["b"]["c"].float().numpy(), np.ones((3, 4)))
        assert int(out["n"]) == 3

    def test_model_and_optimizer_roundtrip_bit_exact(self, tmp_path):
        """(LM, AdamW state), bf16 parameters among float32 ones: the module
        is loaded in place, every leaf equal bit for bit; the on-disk layout
        is the reference's (manifest, shards, COMMIT marker, no tmp dir)."""
        cfg = get_smoke_config("qwen3_0_6b")
        params = init_params(cfg, seed=0, device="cpu")
        opt = adamw_init(params)
        opt["mu"] = {k: torch.randn(v.shape) for k, v in opt["mu"].items()}
        path = save_checkpoint(tmp_path, 12, (params, opt), extra={"data_step": 12})
        assert sorted(p.name for p in path.iterdir()) == [".COMMIT", "manifest.json",
                                                          "shard_00000.npz"]
        assert [p.name for p in tmp_path.iterdir()] == ["step_000000012"]
        fresh = init_params(cfg, seed=1, device="cpu")
        (got, got_opt), step, _ = restore_checkpoint(tmp_path, (fresh, adamw_init(fresh)))
        assert got is fresh and step == 12
        for (name, a), b in zip(params.named_parameters(), got.parameters()):
            assert a.dtype == b.dtype
            if a.dtype == torch.bfloat16:
                assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name
            assert torch.equal(a, b), name
        for part in ("master", "mu", "nu"):
            assert all(torch.equal(opt[part][k], got_opt[part][k]) for k in opt[part])
        assert got_opt["step"].dtype == torch.int32

    def test_bf16_leaves_are_stored_as_the_reference_stores_them(self, tmp_path):
        """A uint8 view plus the dtype name, read back through torch: the
        port reads the reference's bf16 checkpoint bit for bit."""
        x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
        jsave_checkpoint(tmp_path, 3, {"w": jnp.asarray(x, jnp.bfloat16)})
        out, _, _ = restore_checkpoint(tmp_path, {"w": torch.zeros((5, 6), dtype=torch.bfloat16)})
        np.testing.assert_array_equal(out["w"].float().numpy(),
                                      np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))

    def test_latest_step_picks_newest(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        save_checkpoint(tmp_path, 1, tree)
        save_checkpoint(tmp_path, 5, tree)
        assert latest_step(tmp_path) == 5

    def test_torn_checkpoint_ignored(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"x": torch.zeros(3)})
        torn = tmp_path / "step_000000002"
        torn.mkdir()
        (torn / "manifest.json").write_text("{}")
        (tmp_path / "step_000000003.tmp").mkdir()
        assert latest_step(tmp_path) == 1

    def test_shape_mismatch_rejected(self, tmp_path):
        def tree(nx, ny):
            return {"x": torch.zeros(nx), "y": torch.zeros(ny, dtype=torch.bfloat16)}
        save_checkpoint(tmp_path, 1, tree(3, 2))
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(tmp_path, tree(4, 2))
        with pytest.raises(ValueError, match="values"):
            restore_checkpoint(tmp_path, tree(3, 3))
        with pytest.raises(ValueError, match="dtype"):
            restore_checkpoint(tmp_path, {"x": torch.zeros(3, dtype=torch.float64),
                                          "y": torch.zeros(2, dtype=torch.bfloat16)})
        with pytest.raises(ValueError, match="leaves"):
            restore_checkpoint(tmp_path, {"x": torch.zeros(3)})
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(tmp_path / "none", {"x": torch.zeros(3)})


class TestOptimizer:
    def test_update_matches_the_reference(self):
        """Three steps on the same gradients (bf16 and float32 parameters,
        a clipping norm that clips): master, mu, nu and the new parameters
        within 1e-6 of the reference's, the metrics too."""
        rng = np.random.default_rng(0)
        shapes = {"a": ((6, 5), "bfloat16"), "b": ((7,), "float32"), "c": ((3, 2, 4), "float32")}
        init = {k: rng.normal(size=s).astype(np.float32) for k, (s, _) in shapes.items()}
        jparams = {k: jnp.asarray(v, dt) for (k, v), (_, dt) in zip(init.items(), shapes.values())}
        params = {k: _t(np.asarray(v, np.float32)).to(getattr(torch, shapes[k][1]))
                  for k, v in jparams.items()}
        kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
        jopt, opt = jadamw_init(jparams), adamw_init(params)
        for _ in range(3):
            g = {k: rng.normal(size=s[0]).astype(np.float32) for k, s in shapes.items()}
            jg = {k: jnp.asarray(v, jparams[k].dtype) for k, v in g.items()}
            tg = {k: _t(np.asarray(jg[k], np.float32)).to(params[k].dtype) for k in g}
            jparams, jopt, jm = jadamw_update(JOptConfig(**kw), jg, jopt)
            params, opt, m = adamw_update(OptConfig(**kw), tg, opt)
            for k in shapes:
                assert params[k].dtype == getattr(torch, shapes[k][1])
                assert _rel(params[k], np.asarray(jparams[k], np.float32)) < 1e-6, k
                for part in ("master", "mu", "nu"):
                    assert _rel(opt[part][k], jopt[part][k]) < 1e-6, (part, k)   # <= 1.5e-7
            assert int(opt["step"]) == int(jopt["step"])
            assert _rel(m["lr"], jm["lr"]) < 1e-6 and _rel(m["grad_norm"], jm["grad_norm"]) < 1e-6

    def test_descends_quadratic(self):
        cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=100)
        params = {"w": torch.tensor([3.0, -2.0], dtype=torch.bfloat16)}
        opt = adamw_init(params)
        for _ in range(60):
            grads = {"w": (params["w"].float() * 2).to(torch.bfloat16)}   # d/dw w^2
            params, opt, _ = adamw_update(cfg, grads, opt)
        assert float(params["w"].float().abs().max()) < 0.5

    def test_master_weights_fp32(self):
        opt = adamw_init({"w": torch.ones(4, dtype=torch.bfloat16)})
        assert opt["master"]["w"].dtype == torch.float32

    def test_clip_bounds_update(self):
        cfg = OptConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0, warmup_steps=0,
                        total_steps=10)
        opt = adamw_init({"w": torch.zeros(2)})
        _, _, metrics = adamw_update(cfg, {"w": torch.tensor([1e6, -1e6])}, opt)
        assert float(metrics["grad_norm"]) > 1e5  # raw norm reported

    def test_schedule_warmup_and_decay(self):
        cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        assert float(cosine_lr(cfg, torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
        assert float(cosine_lr(cfg, torch.tensor(100, dtype=torch.int32))) == pytest.approx(0.1)


def test_train_step_matches_the_reference():
    """Two steps of ``make_train_step`` on SMOKE Qwen3 in float32 (warmup
    2, so the second step runs at the peak rate) against the reference's
    jitted step on the same parameters and batches from the pipeline."""
    jcfg = dataclasses.replace(jget_smoke_config("qwen3_0_6b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), dtype="float32")
    jp, npp = _perturbed_params(jcfg)
    params = params_from_jax(cfg, npp, device="cpu")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**kw)))
    step = make_train_step(cfg, OptConfig(**kw))
    jopt, opt = jadamw_init(jp), adamw_init(params)
    pipe = make_pipeline(cfg.vocab, 32, 2)
    for t in range(2):
        b = pipe.batch(t)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        assert _rel(m["loss"], jm["loss"]) < 1e-5                 # <= 7.7e-8
        assert _rel(m["grad_norm"], jm["grad_norm"]) < 1e-5       # <= 2.3e-7
        assert _rel(m["lr"], jm["lr"]) < 1e-7
        exp = jax.tree.map(np.asarray, jp)
        P = len(cfg.pattern)
        for g in range(cfg.n_groups):
            for part in ("norm1", "mixer", "norm2", "ffn"):
                for name, got in getattr(params.blocks[g * P], part).items():
                    e = exp["blocks"][0][part][name][g]
                    assert _rel(got.detach(), e) < 1e-4, (t, g, part, name)   # <= 9.5e-6
        assert _rel(params.embed["table"].detach(), exp["embed"]["table"]) < 1e-4


class TestTrainResume:
    ARGS = ["--arch", "qwen3_0_6b", "--smoke", "--batch", "2", "--seq", "32",
            "--log-every", "100", "--device", "cpu"]

    def test_checkpoint_resume_bitexact(self, tmp_path):
        """A 6-step run checkpointing every 3 steps; with its last checkpoint
        gone (the run lost after step 3), ``--resume`` restarts at step 3
        and repeats steps 3-5 bit for bit (the same schedule: the reference
        test's shorter first leg decays its learning rate sooner, hence its
        rel 1e-3)."""
        ck = tmp_path / "c1"
        l_full = train.main(self.ARGS + ["--steps", "6", "--ckpt-dir", str(ck),
                                         "--ckpt-every", "3"])
        assert latest_step(ck) == 6
        shutil.rmtree(ck / "step_000000006")
        l_resumed = train.main(self.ARGS + ["--steps", "6", "--ckpt-dir", str(ck), "--resume"])
        assert len(l_resumed) == 3
        assert l_resumed == l_full[3:]
        assert latest_step(ck) == 6

    def test_elastic_shrink_handoff_bitexact(self, tmp_path, capsys):
        """The elastic path (checkpoint at the shrink step, plan_shrink,
        rebuild on the single-device path, restore) matches the
        uninterrupted run."""
        l_full = train.main(self.ARGS + ["--steps", "6"])
        l_elastic = train.main(self.ARGS + [
            "--steps", "6", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "100",
            "--elastic-shrink-at", "3", "--elastic-devices", "3"])
        assert l_elastic == l_full
        assert ("elastic shrink at step 3: 3 healthy devices -> mesh (1, 2) "
                "(single-device lowering); re-lowered and restored") in capsys.readouterr().out

    def test_elastic_shrink_requires_checkpoint_dir(self):
        with pytest.raises(SystemExit):
            train.main(self.ARGS + ["--steps", "4", "--elastic-shrink-at", "2"])

    def test_embedding_configs_train(self):
        """The trainer feeds the stub frontend (and arange position ids)."""
        for arch in ("musicgen_medium", "qwen2_vl_72b"):
            losses = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                                 "--seq", "32", "--device", "cpu"])
            assert len(losses) == 2 and all(np.isfinite(losses))
