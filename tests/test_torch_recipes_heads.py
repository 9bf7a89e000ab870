"""The multi-output 2D family's smoke recipe against the JAX package's
(``test_torch_recipes.py`` holds the check)."""

from test_torch_recipes import check_recipe


def test_recipe_matches_jax(tmp_path):
    check_recipe("multi_output_unet", tmp_path)
