"""The port's mobile nets and InceptionV3 against the JAX package's flax
modules, by the checks of ``test_torch_zoo.py`` (a file of their own for
the time their flax steps take to compile)."""

import pytest

from test_torch_zoo import check_family


@pytest.mark.parametrize("family", ["mobilenet0.25", "mobilenetv2_0.25",
                                    "inceptionv3"])
def test_zoo_family_matches_flax(family, monkeypatch):
    check_family(family, monkeypatch)
