"""The port's entry points against the JAX package's: the CLI
(`controlar_tpu_torch/cli.py`), the demo engine, verify-zoo and tools.

- the parser: every JAX subcommand but `bench`, with the same option names;
  the allowed differences are listed in `ADDED` / `ABSENT`;
- `_build_pipeline` of both packages on the same reference-layout `.pt`
  files: the loaded GPT greedy token for token, the adapter's features and
  the VQ decoder's images; `sample-c2i` of both CLIs at top_k 1 writes the
  same images;
- the other commands run end to end on the CPU (serve-warmup, serve,
  quant-report, sample-fid, extract -> pack-data, train-c2i from a .car);
- `DemoEngine.process` against the JAX package's (the inputs of
  `tests/test_demo_engine.py`), its checkpoint hot-swap, the Blocks UI;
- `check_code_tree`, the hub folder and the Lightning conversion both ways;
  `GateResult` lines, `verify_zoo_dir`, and `self_test` without the
  reference.

Sizes are cut for the CPU: a registered tiny GPT size, a narrow VQ and a
one-layer adapter in both packages (the CLIs read them at call time).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controlar_tpu import cli as jcli
from controlar_tpu import config as jconfig
from controlar_tpu import demo as jdemo
from controlar_tpu import generate as jgen
from controlar_tpu import tools as jtools
from controlar_tpu import verify_zoo as jzoo
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu_torch import cli as tcli
from controlar_tpu_torch import config as tconfig
from controlar_tpu_torch import convert_ref
from controlar_tpu_torch import demo as tdemo
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import tools as ttools
from controlar_tpu_torch import verify_zoo as tzoo
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq

# ---------------------------------------------------------------------------
# The parser
# ---------------------------------------------------------------------------

# differences from the JAX CLI, each with its reason
ABSENT = {"bench": "waits for the port's own benchmark (a PR of its own)"}
ADDED = {"--device": "every command runs on the card unless --device cpu is given"}


def _help(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().out


def _commands(main, capsys):
    return set(re.search(r"\{([a-z0-9,-]+)\}", _help(main, ["--help"], capsys))
               .group(1).split(","))


def _options(main, cmd, capsys):
    """The option names of a subcommand, from the entries of its --help."""
    text = _help(main, [cmd, "--help"], capsys)
    return {o for line in text.splitlines() if re.match(r"^  -", line)
            for o in re.findall(r"(--[a-z0-9-]+)", line.split("  ")[1])}


def test_parser_has_every_jax_command_but_bench(capsys):
    want = _commands(jcli.main, capsys) - set(ABSENT)
    assert _commands(tcli.main, capsys) == want
    assert "bench" not in _commands(tcli.main, capsys)


JAX_COMMANDS = ["sample-c2i", "train-t2i", "serve-warmup", "quant-report", "pack-data",
                "train-c2i", "sample-t2i", "train-vq", "serve", "eval-vq", "verify-zoo",
                "eval-miou", "sample-fid", "test-consistency", "eval-t2i", "eval-c2i", "extract"]


@pytest.mark.parametrize("cmd", JAX_COMMANDS)
def test_command_has_the_jax_options(cmd, capsys):
    want = _options(jcli.main, cmd, capsys)
    got = _options(tcli.main, cmd, capsys)
    assert got - set(ADDED) == want - set(ADDED), (got ^ want)
    assert "--device" in got
    sub = {a.dest: a for a in
           tcli.build_parser()._subparsers._group_actions[0].choices[cmd]._actions}
    assert sub["device"].default == "cuda"  # eval-miou / eval-t2i defaulted to cpu in JAX


# ---------------------------------------------------------------------------
# Tiny sizes in both packages
# ---------------------------------------------------------------------------

TINY_GPT = dict(n_layer=3, n_head=2, dim=64)
TINY_VQ = dict(ch=16, z_channels=16)
TINY_VIT = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4,
                layerscale=True, layer_norm_eps=1e-6)
PX = 64


@pytest.fixture
def tiny(monkeypatch):
    """GPT-TINY registered, VQ-16 narrowed and DINOv2-small cut to one layer
    in both packages."""
    monkeypatch.setitem(jconfig._GPT_SIZES, "GPT-TINY", TINY_GPT)
    monkeypatch.setitem(tconfig._GPT_SIZES, "GPT-TINY", TINY_GPT)
    monkeypatch.setattr(jconfig, "vq_config", lambda name, **kw: jconfig.VQConfig(**TINY_VQ))
    monkeypatch.setattr(tconfig, "vq_config", lambda name, **kw: tconfig.VQConfig(**TINY_VQ))
    monkeypatch.setattr(jvit, "DINOV2_SMALL", jvit.ViTConfig(**TINY_VIT))
    monkeypatch.setattr(tvit, "DINOV2_SMALL", tvit.ViTConfig(**TINY_VIT))


@pytest.fixture
def ref_files(tiny, tmp_path):
    """Reference-layout .pt files of seed-made weights: the GPT ({"model":
    sd}), the VQ and the DINOv2 adapter (HF layout)."""
    cfg = tconfig.gpt_config("GPT-TINY", model_type="c2i", block_size=(PX // 16) ** 2,
                             cls_token_num=1)
    gpt = tgpt.init_gpt(cfg, seed=3)
    vq = tvq.init_vq(tconfig.VQConfig(**TINY_VQ), seed=4)
    acfg = tvit.ViTConfig(**TINY_VIT)
    adapter = tvit.init_vit(acfg, seed=5)
    files = {"gpt": tmp_path / "gpt.pt", "vq": tmp_path / "vq.pt", "adapter": tmp_path / "ad.pt"}
    torch.save({"model": convert_ref.gpt_reference_state_dict(gpt)}, files["gpt"])
    torch.save({"model": convert_ref.vq_reference_state_dict(vq)}, files["vq"])
    torch.save(convert_ref.vit_hf_state_dict(adapter, acfg, "dinov2"), files["adapter"])
    return {k: str(v) for k, v in files.items()}


def _cond_images(n, seed=0):
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, PX // 16, PX // 16, 3)).astype(np.uint8)
    return low.repeat(16, axis=1).repeat(16, axis=2)


def _model_argv(files, *extra):
    return ["--gpt-model", "GPT-TINY", "--gpt-ckpt", files["gpt"], "--vq-ckpt", files["vq"],
            "--adapter-ckpt", files["adapter"], "--image-size", str(PX), *extra]


MARGIN = 1e-4


def test_build_pipeline_loads_what_the_jax_cli_loads(ref_files, monkeypatch):
    args = tcli.build_parser().parse_args(["sample-c2i", *_model_argv(ref_files),
                                           "--device", "cpu"])
    tpipe = tcli._build_pipeline(args, "c2i")
    jpipe = jcli._build_pipeline(args, "c2i")
    imgs = _cond_images(2)
    feats = tpipe.control_features(tpipe.extract_condition(imgs))
    jfeats = np.asarray(jpipe.control_features(jpipe.extract_condition(imgs)))
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-4 * np.abs(jfeats).max())
    labels = np.array([207, 3])
    seen = []
    real = tgen.sample_from
    monkeypatch.setattr(tgen, "sample_from",
                        lambda lg, *a, **k: seen.append(lg.clone()) or real(lg, *a, **k))
    got = tgen.generate(tpipe.gpt, tpipe.gpt_cfg, labels=labels, adapter_features=feats,
                        max_new_tokens=16, cfg_scale=4.0, sample_logits=False,
                        cache_dtype=torch.float32, device="cpu").numpy()
    want = np.asarray(jgen.generate(jpipe.gpt_params, jpipe.gpt_cfg, labels=jnp.asarray(labels),
                                    adapter_features=jnp.asarray(feats.numpy()),
                                    max_new_tokens=16, cfg_scale=4.0, sample_logits=False,
                                    use_flash=False, cache_dtype=jnp.float32))
    for b in range(2):  # where the tokens part, the logits must be a near tie
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            top2 = torch.topk(seen[diff[0]][b], 2).values
            assert (top2[0] - top2[1]).item() < MARGIN * seen[diff[0]].abs().max().item()
    codes = torch.as_tensor(want).reshape(2, PX // 16, PX // 16)
    img = tvq.decode_code(tpipe.vq, tpipe.vq_cfg, codes).numpy()
    jimg = np.asarray(jvq.decode_code(jpipe.vq_params, jpipe.vq_cfg, jnp.asarray(codes.numpy())))
    np.testing.assert_allclose(img, jimg, atol=1e-4)


def test_sample_c2i_writes_the_jax_cli_images(ref_files, tmp_path):
    paths = []
    for i, img in enumerate(_cond_images(2, seed=1)):
        paths.append(str(tmp_path / f"cond{i}.png"))
        Image.fromarray(img).save(paths[-1])
    common = _model_argv(ref_files, "--top-k", "1", "--class-labels", "207,golden retriever",
                         "--condition-images", ",".join(paths))
    tcli.main(["sample-c2i", *common, "--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    jcli.main(["sample-c2i", *common, "--output-dir", str(tmp_path / "j")])
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / "t" / f"sample_{i}.png")).astype(int)
        want = np.asarray(Image.open(tmp_path / "j" / f"sample_{i}.png")).astype(int)
        assert got.shape == (PX, PX, 3)
        assert np.abs(got - want).max() <= 1  # the same tokens; uint8 rounding of the decode


def test_commands_run_on_the_cpu(ref_files, tmp_path, capsys):
    m = _model_argv(ref_files)
    tcli.main(["serve-warmup", "--gpt-model", "GPT-TINY", "--image-size", str(PX),
               "--max-slots", "2", "--quantum", "4", "--top-k", "8", "--device", "cpu"])
    assert "admission buckets [2, 2, 2, 1]" in capsys.readouterr().out
    done, stats = tcli.main(["serve", *m, "--class-labels", "1,2,3", "--max-slots", "2",
                      "--quantum", "4", "--top-k", "8", "--quant",
                      "--output-dir", str(tmp_path / "serve"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "serve")) == ["serve_0.png", "serve_1.png",
                                                      "serve_2.png"]
    # 15 decode steps a request: the prefill draws token 0
    assert all(r.tokens.shape == (16,) for r in done) and stats["useful_steps"] == 3 * 15
    tcli.main(["quant-report", "--gpt-model", "GPT-TINY", "--image-size", str(PX),
               "--modes", "int8,int8+kv8", "--max-new-tokens", "8", "--cfg-scale", "1.0",
               "--json-out", str(tmp_path / "q.json"), "--device", "cpu"])
    assert os.path.exists(tmp_path / "q.json")
    tcli.main(["sample-fid", *m, "--num-images", "3", "--batch-size", "2", "--top-k", "8",
               "--output-dir", str(tmp_path / "fid"), "--device", "cpu"])
    assert np.load(tmp_path / "fid" / "samples.npz")["arr_0"].shape == (3, PX, PX, 3)
    # extract a t2i tree from a folder, check it, pack it
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, img in enumerate(_cond_images(3, seed=2)):
        Image.fromarray(img).save(img_dir / f"{i}.png")
    tcli.main(["extract", "--images", str(img_dir), "--vq-ckpt", ref_files["vq"],
               "--image-size", str(PX), "--output-dir", str(tmp_path / "tree"), "--device", "cpu"])
    report = ttools.check_code_tree(str(tmp_path / "tree"), expected_len=3)
    assert report["complete"] and 0 <= report["token_min"] <= report["token_max"] < 16384
    assert report == jtools.check_code_tree(str(tmp_path / "tree"), expected_len=3)


def test_train_c2i_from_a_car(tiny, tmp_path):
    from controlar_tpu_torch.data.carpack import pack_control_dataset
    from tests.torch_parallel_workers import TinyControlDataset

    car = str(tmp_path / "train.car")
    pack_control_dataset(TinyControlDataset(n=4, tokens=16, image_px=PX, vocab=64, classes=10),
                         car)
    state = tcli.main(["train-c2i", "--code-dir", car, "--gpt-model", "GPT-TINY",
                       "--image-size", str(PX), "--global-batch-size", "2", "--max-steps", "2",
                       "--results-dir", str(tmp_path / "res"), "--device", "cpu"])
    assert state.step == 2
    lines = open(tmp_path / "res" / "metrics.jsonl").read().splitlines()
    assert len(lines) >= 1 and "loss" in lines[0]


# ---------------------------------------------------------------------------
# The demo engine
# ---------------------------------------------------------------------------

def _tiny_pipes(tmp_path):
    """The JAX package's demo-test pipeline sizes, in both packages, on the
    same seed-made weights (the JAX side reads the port's reference-layout
    files through its own loaders)."""
    from controlar_tpu import checkpoint as jckpt
    from controlar_tpu.convert.torch_vit import convert_hf_vit_state_dict
    from controlar_tpu.pipeline import ControlARPipeline as JPipe
    from controlar_tpu_torch.pipeline import ControlARPipeline as TPipe

    gkw = dict(model_type="c2i", dim=64, n_layer=4, n_head=2, cls_token_num=1,
               block_size=(PX // 16) ** 2, vocab_size=128, num_classes=1000,
               adapter_size="small")
    vkw = dict(codebook_size=128, codebook_embed_dim=8, z_channels=16, ch=16)
    akw = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4, layerscale=True)
    tg, tv, ta = tconfig.GPTConfig(**gkw), tconfig.VQConfig(**vkw), tvit.ViTConfig(**akw)
    jg, jv, ja = jconfig.GPTConfig(**gkw), jconfig.VQConfig(**vkw), jvit.ViTConfig(**akw)
    gpt, vq, ad = tgpt.init_gpt(tg, seed=0), tvq.init_vq(tv, seed=1), tvit.init_vit(ta, seed=2)
    torch.save({"model": convert_ref.gpt_reference_state_dict(gpt)}, tmp_path / "g.pt")
    torch.save({"model": convert_ref.vq_reference_state_dict(vq)}, tmp_path / "v.pt")
    gp = jax.tree.map(jnp.asarray, jckpt.load_gpt_checkpoint(str(tmp_path / "g.pt"), jg))
    vp = jax.tree.map(jnp.asarray, jckpt.load_vq_checkpoint(str(tmp_path / "v.pt"), jv))
    ap = jax.tree.map(jnp.asarray, convert_hf_vit_state_dict(
        {k: v.numpy() for k, v in convert_ref.vit_hf_state_dict(ad, ta, "dinov2").items()},
        ja, "dinov2"))

    def jfactory(ct):
        return JPipe(gpt_cfg=jg, gpt_params=gp, vq_cfg=jv, vq_params=vp, adapter_cfg=ja,
                     adapter_params=ap, condition_type=ct)

    def tfactory(ct):
        return TPipe(gpt_cfg=tg, gpt=gpt, vq_cfg=tv, vq=vq, adapter_cfg=ta, adapter=ad,
                     condition_type=ct, device="cpu")

    return jfactory, tfactory, tg


def test_demo_engine_process_matches_jax(tmp_path):
    jfactory, tfactory, tg = _tiny_pipes(tmp_path)
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), np.uint8)
    kw = dict(label="golden retriever", cfg_scale=2.0, top_k=1, seed=1)
    teng = tdemo.DemoEngine(tfactory)
    got = teng.process(img, "canny", **kw)
    want = jdemo.DemoEngine(jfactory).process(img, "canny", **kw)
    assert got.shape == (PX, PX, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert teng.get_pipe("canny") is teng.get_pipe("canny")  # cached

    # hot-swap: a condition's reference .pt replaces the GPT in both
    other = tgpt.init_gpt(tg, seed=9)
    path = str(tmp_path / "swap.pt")
    torch.save({"model": convert_ref.gpt_reference_state_dict(other)}, path)
    tswap = tdemo.DemoEngine(tfactory, ckpt_map={"canny": path}).get_pipe("canny")
    jswap = jdemo.DemoEngine(jfactory, ckpt_map={"canny": path}).get_pipe("canny")
    want_emb = other.tok_embeddings.weight.detach().numpy()
    np.testing.assert_array_equal(tswap.gpt.tok_embeddings.weight.detach().numpy(), want_emb)
    np.testing.assert_allclose(np.asarray(jswap.gpt_params["tok_embeddings"]), want_emb,
                               atol=1e-6)


def test_demo_blocks_ui_runs_the_engine(tmp_path):
    from tests.test_demo_engine import _FakeGradio

    _, tfactory, _ = _tiny_pipes(tmp_path)
    gr = _FakeGradio()
    assert tdemo.build_demo(tdemo.DemoEngine(tfactory), "c2i", _gr=gr) is not None
    kinds = [c.kind for c in gr.components]
    assert kinds.count("TabItem") == 2 and kinds.count("Button") == 2
    fn, inputs, _ = [c for c in gr.clicks if len(c[1]) == 12][0]  # the edge tab
    img = np.zeros((24, 24, 3), np.uint8)
    for pre in ("Canny", "No preprocess"):
        res = fn(img, "207", pre, 4.0, 1.0, 16, 1.0, 1.0, 0, False, 100, 200)
        assert res.shape == (PX, PX, 3)


# ---------------------------------------------------------------------------
# tools and verify-zoo
# ---------------------------------------------------------------------------

def test_check_code_tree_matches_jax(tmp_path):
    code = tmp_path / "tree" / "code"
    code.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in (0, 1, 2, 4):  # index 3 missing
        np.save(code / f"{i}.npy", rng.integers(5, 900, (1, 16)))
    for expected in (None, 4, 5):
        assert (ttools.check_code_tree(str(tmp_path / "tree"), expected)
                == jtools.check_code_tree(str(tmp_path / "tree"), expected))


def test_hub_folder_reads_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    params = {"gpt": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                      "layers": [rng.standard_normal(2).astype(np.float32)] * 2},
              "n": np.arange(5, dtype=np.int32)}
    cfg = {"size": "GPT-B", "tokens": 576}
    ttools.save_hub_folder(params, cfg, str(tmp_path / "t"), model_card="# card\n")
    jtree, jcfg = jtools.load_hub_folder(str(tmp_path / "t"))
    assert jcfg == cfg and open(tmp_path / "t" / "README.md").read() == "# card\n"
    np.testing.assert_array_equal(jtree["gpt"]["w"], params["gpt"]["w"])
    np.testing.assert_array_equal(jtree["gpt"]["layers"][1], params["gpt"]["layers"][1])
    np.testing.assert_array_equal(jtree["n"], params["n"])
    jtools.save_hub_folder(params, cfg, str(tmp_path / "j"))
    ttree, tcfg = ttools.load_hub_folder(str(tmp_path / "j"))
    assert tcfg == cfg and isinstance(ttree["gpt"]["layers"], list)
    np.testing.assert_array_equal(ttree["gpt"]["w"].numpy(), params["gpt"]["w"])
    np.testing.assert_array_equal(ttree["n"].numpy(), params["n"])


def test_lightning_conversion_matches_jax(tmp_path):
    sd = {"model.w": torch.randn(3, 2), "model.b": torch.zeros(2)}
    src = tmp_path / "l.ckpt"
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {"lr": 1e-4}}, src)
    ttools.convert_lightning_checkpoint(str(src), str(tmp_path / "t.pt"))
    jtools.convert_lightning_checkpoint(str(src), str(tmp_path / "j.pt"))
    got = torch.load(tmp_path / "t.pt", weights_only=True)
    want = torch.load(tmp_path / "j.pt", weights_only=True)
    assert got.keys() == want.keys() == {"model"}
    assert all(torch.equal(got["model"][k], want["model"][k]) for k in sd)


@pytest.mark.parametrize("quant", [None, {"int8": {"teacher_forced_agreement": 0.9987,
                                                   "max_rel_logit_err": 0.00421}}])
@pytest.mark.parametrize("agreement,passed", [(1.0, True), (0.984375, False)])
def test_gate_result_lines_match_jax(quant, agreement, passed):
    kw = dict(name="hed.safetensors", agreement=agreement, n_tokens=2048, passed=passed,
              quant=quant)
    assert tzoo.GateResult(**kw).line() == jzoo.GateResult(**kw).line()


def test_verify_zoo_dir_and_self_test_without_the_reference(tmp_path):
    (tmp_path / "unrelated.safetensors").write_bytes(b"")
    assert tzoo.verify_zoo_dir(str(tmp_path), device="cpu") == []
    assert tzoo.ZOO.keys() == jzoo.ZOO.keys()
    if os.path.isdir(os.path.join(tzoo.REFERENCE_ROOT, "autoregressive")):
        assert tzoo.self_test("c2i", str(tmp_path), device="cpu").passed
    else:  # the gate never passes without the reference it compares against
        with pytest.raises(FileNotFoundError, match="reference"):
            tzoo.self_test("c2i", str(tmp_path), device="cpu")
        with pytest.raises(FileNotFoundError):
            tcli.main(["verify-zoo", "--self-test", "--device", "cpu"])
