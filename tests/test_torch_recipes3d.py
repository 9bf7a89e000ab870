"""The 3D families' smoke recipes against the JAX package's
(``test_torch_recipes.py`` holds the check)."""

import pytest

from test_torch_recipes import check_recipe


@pytest.mark.parametrize("family", ["unet3d", "multi_output_unet3d"])
def test_recipe_matches_jax(family, tmp_path):
    check_recipe(family, tmp_path)
