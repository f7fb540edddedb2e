"""The comparison that decides `correct` on the CPU at tiny widths: a sound
run passes, and with the timed path broken underneath (a token altered
where it is produced; a training step that returns its state unchanged,
leaves out half of the batch or skips its dropout) the rest of a run sees
`correct` false. The controls (the program's lower-precision path; the fp8
reference in the program's place) read above the sound runs.

The tiny limits below stand in for the cells' own at these widths, where
the program computes the GPT in fp32: a sound generation run reads a mean
logit gap of 0 to 2e-5, a sound training run (bf16 compute) loss, gradient
and update gaps of about 3e-5, 3e-3 and 8e-3."""
import copy

import pytest
import torch

from portbench import run
from portbench.tests import tiny

LIMITS = {"logit_gap_mean": 1e-4, "pixel_err": 0.05, "loss_gap": 1e-3, "grad_gap": 0.03,
          "update_gap": 0.05}
GEN, TRAIN = "gen.gpt3b_c2i384.b32", "train.gptxl_t2i512.b32"


def one(root, workload, control=0):
    return run.run(["--workload", workload, "--seed", str(2 ** 32 + 5), "--seconds", "1.5",
                    "--control", str(control)], require_cuda=False, root=root)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path, LIMITS)


@pytest.mark.parametrize("workload", [GEN, TRAIN, "gen.gptxl_t2i512.b32"])
def test_sound_runs_pass(root, workload):
    res = one(root, workload)
    assert res["correct"], res["checked"]


def _alter(fn):
    """Every token moved to the next vocabulary entry where it is produced."""
    def altered(logits, *args, **kwargs):
        return (fn(logits, *args, **kwargs) + 1) % logits.shape[-1]
    return altered


@pytest.mark.parametrize("workload", [GEN, "gen.gptxl_t2i512.b32"])
def test_a_token_altered_where_it_is_produced(root, workload, monkeypatch):
    import controlar_tpu_torch.generate as tgen

    monkeypatch.setattr(tgen, "sample_from", _alter(tgen.sample_from))
    res = one(root, workload)
    assert not res["correct"]
    assert res["checked"]["logit_gap_mean"]["value"] > LIMITS["logit_gap_mean"]


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    import controlar_tpu_torch.train.control_step as cs
    from controlar_tpu_torch.train.optimizer import AdamState
    from controlar_tpu_torch.train.step import TrainState

    real = cs.apply_step

    def unchanged(wrapper, prefix, state, *a, **k):
        keep = copy.deepcopy((state.params, state.opt_state))
        new, metrics = real(wrapper, prefix, state, *a, **k)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(keep[0][n])
        return TrainState(new.step, state.params, AdamState(new.opt_state.count, keep[1].mu,
                                                            keep[1].nu)), metrics

    monkeypatch.setattr(cs, "apply_step", unchanged)
    res = one(root, TRAIN)
    assert not res["correct"]
    assert res["checked"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root, monkeypatch):
    from controlar_tpu_torch.train.trainer import Trainer

    real = Trainer.put_batch

    def half(self, batch):
        out = real(self, batch)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(Trainer, "put_batch", half)
    res = one(root, TRAIN)
    assert not res["correct"]


def test_the_programs_lower_precision_reads_higher(root):
    """Greedy tokens of the W8A16 + int8-cache path, bf16 adapter and
    tokenizer part from the reference's best where the fp32 program's do
    not."""
    sound, control = one(root, GEN), one(root, GEN, control=1)
    assert control["checked"]["logit_gap_mean"]["value"] > max(
        10 * sound["checked"]["logit_gap_mean"]["value"], LIMITS["logit_gap_mean"])
    assert control["checked"]["pixel_err"]["value"] > sound["checked"]["pixel_err"]["value"]


@pytest.mark.parametrize("site", ["element", "class"])
def test_dropout_skipped_where_the_step_should_apply_it(root, monkeypatch, site):
    """The configuration's dropout left out of the program's step (element
    dropout, or the CFG class dropout): the replayed reference parts from it.
    Two rows a step seldom draw a class drop at 0.1, so that case runs a
    copy of the configuration at 0.9, where a sound run passes."""
    import json

    import controlar_tpu_torch.models.gpt as gpt_model
    import controlar_tpu_torch.train.control_step as cs

    if site == "element":
        monkeypatch.setattr(gpt_model, "_dropout", lambda key, p, x: x)
    else:
        path = root / "portbench" / "configs" / "gptxl_t2i512.json"
        cfg = json.loads(path.read_text())
        cfg["train"]["class_dropout"] = 0.9
        path.write_text(json.dumps(cfg))
        assert one(root, TRAIN)["correct"]
        monkeypatch.setattr(cs, "drop_ids", lambda cfg, b, key, device:
                            torch.zeros(b, dtype=torch.bool, device=device))
    res = one(root, TRAIN)
    assert not res["correct"], res["checked"]


def test_the_fp8_reference_reads_higher():
    """controls.py at a tiny size: fp8 in the program's place reads above a
    sound tiny run, the fp32 reference against itself reads 0."""
    from portbench import controls
    from portbench.harness import manifest, program

    train = manifest.Manifest(tiny.ROOT).load("loops", "train")
    cfg = tiny.config("gptxl_t2i512")
    traffic = dict(checked_steps=3, batch=2, reference_rows=1, caption_min=2, caption_max=8)
    out = {}
    for fault in ("none", "fp8", "half_batch"):
        prog = controls.Readings(cfg, traffic, 9, torch.device("cpu"), fault,
                                 train.drop_seed(cfg, 9))
        out[fault] = dict(train.reference_train_numbers(
            prog, program.reference_weights(cfg, 9, "cpu", parts=("gpt", "adapter"))))
    assert max(out["none"].values()) < 1e-5
    assert max(out["fp8"].values()) > LIMITS["loss_gap"]
    assert out["half_batch"]["grad_gap"] > LIMITS["grad_gap"]
