"""The scene corpus through ``collide`` (column pipeline), float32."""

import pytest

from scene_corpus import MODES, SCENES, check_collide


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_collide_scene(name, mode):
    check_collide(name, mode)
