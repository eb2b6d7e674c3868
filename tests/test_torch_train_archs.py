"""The port's training entry points against ``repro``'s for the five archs
``test_torch_train_model.py`` does not hold: SSD (``mamba2-130m``), SSD +
GQA + MoE (``jamba-v0.1-52b``), the cross stacks (``whisper-large-v3``'s
encoder, ``llama-3.2-vision-11b``'s ``vision_proj``) and ``qwen3-32b``
(qk-norm).  The checks and their tolerances are that file's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_model import (CHUNK, check_loss_and_grads,  # noqa: E402,F401
                                   check_train_step, one_thread)

ARCHS = ("jamba-v0.1-52b", "mamba2-130m", "whisper-large-v3", "llama-3.2-vision-11b",
         "qwen3-32b")


@pytest.mark.parametrize("chunk", [0, CHUNK])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name, chunk):
    check_loss_and_grads(name, chunk)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    check_train_step(name)
