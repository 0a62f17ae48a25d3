from raytracer_tpu_torch.scene.model import (  # noqa: F401
    Material,
    Mesh,
    Object,
    Scene,
    SceneChange,
    SceneChangeType,
    Transform,
    create_cornell_box,
    create_plane,
    create_sphere,
)
from raytracer_tpu_torch.scene.loaders import load_scene  # noqa: F401
from raytracer_tpu_torch.scene.device_scene import DeviceScene, bake_scene  # noqa: F401
