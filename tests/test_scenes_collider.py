"""The scene corpus through ``Collider.get_collisions``, float32: default
knobs, so wide-window scenes exercise the retry ladder."""

import pytest

from scene_corpus import MODES, SCENES, check_collider


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_collider_scene(name, mode):
    check_collider(name, mode)
