"""Inputs shared by the port's text and data tests (test_torch_t5,
test_torch_data, test_torch_extract): the JAX package's VQ and tiny T5
parameter trees filled from numpy, and the JAX embedder over a stand-in
tokenizer."""
import jax
import jax.numpy as jnp
import numpy as np

from controlar_tpu.models import t5 as jt5
from controlar_tpu.models import vq as jvq
from controlar_tpu.text.embedder import T5Embedder as JT5Embedder
from controlar_tpu_torch import cells

# tests/test_t5.py's tiny configuration
T5_TINY = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, n_layer=3, n_head=4)


def random_vq_params(cfg, seed=0):
    """The JAX package's VQ tree (its structure traced from
    `init_vq_params`, not run) filled from numpy: convolutions uniform in
    +-1/sqrt(fan_in), norms near one and zero, a random codebook."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvq.init_vq_params(jax.random.PRNGKey(0), cfg))

    def fill(path, s):
        leaf = path[-1].key if hasattr(path[-1], "key") else None
        if leaf == "w":
            bound = 1 / np.sqrt(np.prod(s.shape[:3]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    params["codebook"] = rng.standard_normal(shapes["codebook"].shape).astype(np.float32)
    return params


def tiny_t5_params(seed=0):
    """The JAX package's T5 tree at T5_TINY filled from numpy: matrices
    normal(0, 0.05), the embedding normal(0, 1), the bias table normal(0,
    0.5), norms 1 + normal(0, 0.1), so every weight moves the output."""
    rng = np.random.default_rng(seed)
    c = T5_TINY
    L, d, inner, dff = c["n_layer"], c["d_model"], c["n_head"] * c["d_kv"], c["d_ff"]

    def nrm(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "embedding": nrm(c["vocab_size"], d, std=1.0), "rel_bias": nrm(32, c["n_head"], std=0.5),
        "layers": {"ln1": 1 + nrm(L, d, std=0.1), "q": nrm(L, d, inner), "k": nrm(L, d, inner),
                   "v": nrm(L, d, inner), "o": nrm(L, inner, d), "ln2": 1 + nrm(L, d, std=0.1),
                   "wi0": nrm(L, d, dff), "wi1": nrm(L, d, dff), "wo": nrm(L, dff, d)},
        "final_ln": 1 + nrm(d, std=0.1),
    }


class HFLikeTokenizer:
    """The JAX embedder's (HF) tokenizer interface over `cells.word_tokenizer`."""

    def __init__(self, vocab_size):
        self.tok = cells.word_tokenizer(vocab_size)

    def __call__(self, texts, max_length, padding, truncation, return_tensors):
        assert (padding, truncation, return_tensors) == ("max_length", True, "np")
        ids, mask = self.tok(texts, max_length)
        return {"input_ids": ids, "attention_mask": mask}


def jax_t5_embedder(params, max_length):
    """The JAX package's T5Embedder on `params` (T5_TINY) with the stand-in
    tokenizer; its __init__, which loads an HF tokenizer from disk, is
    bypassed."""
    emb = object.__new__(JT5Embedder)
    emb.tokenizer = HFLikeTokenizer(T5_TINY["vocab_size"])
    emb.params, emb.cfg = jax.tree.map(jnp.asarray, params), jt5.T5Config(**T5_TINY)
    emb.model_max_length, emb.use_text_preprocessing = max_length, True
    return emb
