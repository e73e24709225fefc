"""A float64 subset of the scene corpus: the column pipeline tests AABBs
at input precision through both entry points."""

import pytest

from scene_corpus import F64_SCENES, MODES, check_collide, check_collider


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", F64_SCENES)
def test_collide_scene_f64(name, mode):
    check_collide(name, mode, "float64")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", F64_SCENES)
def test_collider_scene_f64(name, mode):
    check_collider(name, mode, "float64")
