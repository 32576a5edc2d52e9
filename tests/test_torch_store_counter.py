"""The port's sealed image under the counter-mode engine, word for word
against the JAX package (the ColoE cases and the helper live in
test_torch_store.py; the two files split the reference's slow eager
sealing between test workers)."""
import pytest

from test_torch_store import (check_sealed_image,  # noqa: F401
                              jitted_reference_chacha, params)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_sealed_image_word_for_word_counter(params, ratio, monkeypatch):
    check_sealed_image(params, "counter", ratio, monkeypatch)
