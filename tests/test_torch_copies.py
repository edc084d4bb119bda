"""The port imports nothing of the JAX package, and its own copies of the
host modules it needs behave as the originals.

`plangen_tpu_torch/config.py`, `plangen_tpu_torch/text/` and
`plangen_tpu_torch/convert/export.py` are copies of `plangen_tpu/config.py`,
`plangen_tpu/text/` and the exporter of `plangen_tpu/convert/jax_to_torch.py`.
These tests scan the port's sources (and `chip_smoke.py`) for imports of
`plangen_tpu`, import every port module in a fresh interpreter and look at
`sys.modules`, and hold each copy against its original on seeded inputs.
"""

import ast
import dataclasses
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import plangen_tpu.config as jcfg
import plangen_tpu.text.batching as jbatching
import plangen_tpu.text.chat_template as jchat
import plangen_tpu.text.grounding as jgrounding
import plangen_tpu.text.tokenizer as jtokenizer
import plangen_tpu_torch.config as tcfg
import plangen_tpu_torch.text.batching as tbatching
import plangen_tpu_torch.text.chat_template as tchat
import plangen_tpu_torch.text.grounding as tgrounding
import plangen_tpu_torch.text.tokenizer as ttokenizer
from plangen_tpu.convert.jax_to_torch import export_state_dict as jexport
from plangen_tpu.models import vlm as jvlm
from plangen_tpu_torch.convert.export import export_state_dict as texport

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((REPO / "plangen_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


# ------------------------------------------------------------------ imports


def _imports_of_jax_package(path: pathlib.Path):
    """Every `import plangen_tpu...` / `from plangen_tpu... import` in the
    file, at any depth (lazy imports inside functions included)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n == "plangen_tpu" or n.startswith("plangen_tpu.")]
    return found


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_nothing_of_the_jax_package(path):
    assert _imports_of_jax_package(path) == []


@pytest.mark.parametrize("module", ["runtime/speculative.py", "runtime/jacobi.py",
                                    "convert/params.py", "convert/export.py",
                                    "data/native.py", "parallel/mesh.py"])
def test_the_scan_covers_the_decoders_and_the_artifacts(module):
    assert REPO / "plangen_tpu_torch" / module in PORT_SOURCES


def test_native_binding_copy_has_the_same_interface():
    """`plangen_tpu_torch/data/native.py` binds the same library with the
    same functions (tests/test_torch_datasets.py runs both on one build)."""
    import plangen_tpu.data.native as jnative
    import plangen_tpu_torch.data.native as tnative

    for name in ("native_available", "resize_bilinear_native",
                 "resize_bilinear_batch_native", "resize_to_model_input"):
        assert inspect.signature(getattr(tnative, name)) == \
            inspect.signature(getattr(jnative, name)), name
    assert tnative._SO_PATH == jnative._SO_PATH


def test_the_scan_sees_an_import_of_the_jax_package(tmp_path):
    """The scan itself finds a lazy import inside a function."""
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from plangen_tpu.config import LlamaConfig\n"
                     "    import plangen_tpu.text as t\n    import plangen_tpu_torch\n")
    assert _imports_of_jax_package(probe) == ["probe.py:2 plangen_tpu.config",
                                             "probe.py:3 plangen_tpu.text"]


def test_importing_every_port_module_loads_nothing_of_the_jax_package():
    """In a fresh interpreter (this one has the JAX package loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import plangen_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(plangen_tpu_torch.__path__, "
        "'plangen_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'plangen_tpu' or k.startswith('plangen_tpu.'))\n"
        "jax_loaded = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "print(len(names), bad, jax_loaded[:3])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")[-2]
    n, rest = out.split(" ", 1)
    assert int(n) > 30 and rest == "[] []", out


# ------------------------------------------------------------------ config


def _dataclasses(module):
    return sorted(name for name, obj in vars(module).items()
                  if dataclasses.is_dataclass(obj) and obj.__module__ == module.__name__)


def _constructors(module):
    """(class name, constructor name) of every dataclass's default
    constructor and its static / class-method constructors."""
    out = []
    for name in _dataclasses(module):
        cls = getattr(module, name)
        out.append((name, None))
        for attr, obj in vars(cls).items():
            if isinstance(obj, (staticmethod, classmethod)) and \
                    not inspect.signature(getattr(cls, attr)).parameters:
                out.append((name, attr))
    return out


def test_config_copy_has_the_same_dataclasses():
    assert _dataclasses(tcfg) == _dataclasses(jcfg)
    assert len(_dataclasses(tcfg)) >= 10


@pytest.mark.parametrize("name,ctor", _constructors(jcfg),
                         ids=lambda x: "default" if x is None else x)
def test_config_copy_constructs_the_same(name, ctor):
    """Field names, types as written, defaults, and the whole tree as
    `dataclasses.asdict` of each constructor."""
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [(f.name, str(f.type)) for f in dataclasses.fields(tc)] == \
        [(f.name, str(f.type)) for f in dataclasses.fields(jc)]
    j = jc() if ctor is None else getattr(jc, ctor)()
    t = tc() if ctor is None else getattr(tc, ctor)()
    assert type(t) is tc
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


GOOD_OVERRIDES = [
    {"train.optim.learning_rate": "1e-4", "generation.cfg_weight": "3.5"},
    {"generation.quantize": "int4", "generation.output_uint8": "true"},
    {"train.train_data": "({'task_type': 'uni'},)", "use_textual": "False",
     "use_numhw_tokens": "True"},
    {"generation.neg_prompt": '"none"', "train.mesh_shape.data": "2"},
]
BAD_OVERRIDES = [
    {"generation.quantize": "int3"},  # validate_config: unknown mode
    {"use_textual": "false"},  # validate_config: numhw tokens needed
    {"generation.kv_a8": "true"},  # validate_config: kv_a8 without quantize
    {"generation.speculative": "true", "generation.quantize": "int8"},
    {"generation.no_such_field": "1"},  # apply_overrides: unknown key
    {"model.llama.hidden_size.x": "1"},  # apply_overrides: not a dataclass
]


@pytest.mark.parametrize("overrides", GOOD_OVERRIDES, ids=lambda o: ",".join(o))
def test_config_copy_applies_overrides_the_same(overrides):
    j = jcfg.validate_config(jcfg.apply_overrides(jcfg.PlanGenConfig(), overrides))
    t = tcfg.validate_config(tcfg.apply_overrides(tcfg.PlanGenConfig(), overrides))
    assert type(t) is tcfg.PlanGenConfig
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.parse_opt_list([f"{k}={v}" for k, v in overrides.items()]) == \
        jcfg.parse_opt_list([f"{k}={v}" for k, v in overrides.items()])


@pytest.mark.parametrize("overrides", BAD_OVERRIDES, ids=lambda o: ",".join(o))
def test_config_copy_refuses_the_same(overrides):
    def outcome(mod):
        try:
            mod.validate_config(mod.apply_overrides(mod.PlanGenConfig(), overrides))
        except (KeyError, TypeError, ValueError) as e:
            return type(e), str(e)
        return None

    j = outcome(jcfg)
    assert j is not None and outcome(tcfg) == j


# -------------------------------------------------------------------- text


def _random_layouts(seed, n=24):
    rs = np.random.RandomState(seed)
    words = ["fox", "teddy bear", "bowl", "a red car", "tree", "日本", "cliff"]
    out = []
    for _ in range(n):
        k = rs.randint(0, 5)
        xy = np.sort(rs.uniform(0, 1, size=(k, 2, 2)), axis=1)  # x1 < x2, y1 < y2
        boxes = [[float(b[0, 0]), float(b[0, 1]), float(b[1, 0]), float(b[1, 1])] for b in xy]
        if k and rs.rand() < 0.2:
            boxes[0] = [0.0, 0.0, 0.0, 0.0]  # an empty box: skipped
        descs = [words[i] for i in rs.randint(0, len(words), size=k)]
        valid = None if rs.rand() < 0.5 else list(rs.rand(k) < 0.8)
        out.append(("a caption" if rs.rand() < 0.8 else "", boxes, descs, valid))
    return out


@pytest.mark.parametrize("textual", [True, False], ids=["textual", "numhw"])
@pytest.mark.parametrize("seed", [0, 1])
def test_grounding_copy_serializes_and_parses_the_same(seed, textual):
    for caption, boxes, descs, valid in _random_layouts(seed):
        text = tgrounding.serialize_grounding(caption, boxes, descs, valid, textual=textual)
        assert text == jgrounding.serialize_grounding(caption, boxes, descs, valid,
                                                      textual=textual)
        assert tgrounding.parse_grounding(text, textual) == \
            jgrounding.parse_grounding(text, textual)
        cut = text[: len(text) * 2 // 3]
        assert tgrounding.truncate_grounding(cut) == jgrounding.truncate_grounding(cut)
        assert tgrounding.extract_grounding_part(text) == jgrounding.extract_grounding_part(text)


def test_chat_template_copy_renders_the_same():
    j, t = jchat.DeepSeekTemplate(), tchat.DeepSeekTemplate()
    g = "<grounding><ref>fox</ref><box>[200, 300, 700, 900]</box></grounding>"
    assert t.t2i_prompt("a fox", "<begin_of_image>") == j.t2i_prompt("a fox", "<begin_of_image>")
    for tag in ("<begin_of_image>", None):
        assert t.uni_prompt("a fox", g, tag) == j.uni_prompt("a fox", g, tag)
    assert t.mmu_prompt("what is it?", "a fox", "<image_placeholder>") == \
        j.mmu_prompt("what is it?", "a fox", "<image_placeholder>")
    assert t.render([tchat.Message("User", "hi"), tchat.Message("Assistant", "")]) == \
        j.render([jchat.Message("User", "hi"), jchat.Message("Assistant", "")])
    assert tchat.MMU_QUESTION == jchat.MMU_QUESTION


@pytest.mark.parametrize("max_seq_len", [None, 7])
def test_batching_copy_pads_and_interleaves_the_same(max_seq_len):
    rs = np.random.RandomState(3)
    rows = [list(rs.randint(3, 1000, size=n)) for n in (5, 1, 9, 4)]
    neg = [list(rs.randint(3, 1000, size=n)) for n in (2, 6, 3, 9)]
    jt = [jbatching.left_pad_batch(r, 0, max_seq_len=max_seq_len) for r in (rows, neg)]
    tt = [tbatching.left_pad_batch(r, 0, max_seq_len=max_seq_len) for r in (rows, neg)]
    for (ja, jm), (ta, tm) in zip(jt, tt):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tm, jm)
    for a, b in zip(tbatching.interleave_cfg(*tt[0], *tt[1]),
                    jbatching.interleave_cfg(*jt[0], *jt[1])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbatching.extend_mask_for_image(tt[0][1], 5),
                                  jbatching.extend_mask_for_image(jt[0][1], 5))


@pytest.mark.parametrize("use_numhw", [False, True])
def test_byte_fallback_tokenizer_copy_encodes_and_decodes_the_same(use_numhw):
    j = jtokenizer.ByteFallbackTokenizer(vocab_size=102400, use_numhw=use_numhw)
    t = ttokenizer.ByteFallbackTokenizer(vocab_size=102400, use_numhw=use_numhw)
    assert dataclasses.asdict(t.special) == dataclasses.asdict(j.special)
    texts = ["a red fox <grounding><ref>fox</ref><box>[1, 2, 3, 4]</box></grounding>",
             "<begin_of_image><image_placeholder> ünïcødé 日本 <h12>,<w3>", ""]
    for text in texts:
        for bos in (True, False):
            ids = t.encode(text, add_bos=bos)
            assert ids == j.encode(text, add_bos=bos)
            for skip in (True, False):
                assert t.decode(ids, skip_special_tokens=skip) == \
                    j.decode(ids, skip_special_tokens=skip)
    tok = ttokenizer.load_tokenizer(None, vocab_size=102400, use_numhw=use_numhw)
    assert isinstance(tok, ttokenizer.ByteFallbackTokenizer)


# ---------------------------------------------------------------- exporter


@pytest.mark.parametrize("name", ["tiny", "tiny_7b"])
def test_exporter_copy_exports_the_same(name):
    """Seeded tiny JAX parameters: the same keys, and every array equal."""
    cfg = getattr(jcfg.PlanGenModelConfig, name)()
    params = jvlm.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    want = jexport(params, cfg)
    got = texport(params, getattr(tcfg.PlanGenModelConfig, name)())
    assert list(got) == list(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_exporter_copy_refuses_quantized_and_lora_trees():
    """A quantized tree is refused as the original refuses it; a tree with
    LoRA adapters is merged (the port's `merge_lora`) exactly as
    `jax_to_torch.export_state_dict` merges it: adapters in eighths and a
    scaling of 1/2, whose products and sums fp32 holds exactly in any order,
    give every array bitwise equal."""
    from plangen_tpu.train import lora as jlora

    cfg = tcfg.PlanGenModelConfig.tiny()
    with pytest.raises(ValueError, match="quantized"):
        texport({"language_model": {"layers": {"q_proj": {"w_q8": 0, "scale": 0}}}}, cfg)
    jc = jcfg.PlanGenModelConfig.tiny()
    params = jvlm.init(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    tree = jlora.init_lora(jax.random.PRNGKey(1), jc.llama, rank=4, alpha=2)
    rs = np.random.RandomState(0)
    for t in jlora.TARGETS:
        for ab in ("a", "b"):
            tree[t][ab] = jnp.asarray(rs.randint(-8, 9, size=tree[t][ab].shape) / 8.0,
                                      jnp.float32)
    params = jlora.add_lora(params, tree)
    want = jexport(params, jc)
    got = texport(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert list(got) == list(want) and not any("lora" in k for k in got)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    merged = texport(jax.tree_util.tree_map(np.asarray, jlora.merge_lora(params)), cfg)
    np.testing.assert_array_equal(got["language_model.model.layers.1.self_attn.o_proj.weight"],
                                  merged["language_model.model.layers.1.self_attn.o_proj.weight"])
