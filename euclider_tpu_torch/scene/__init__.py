from . import ir
from .compile import (CameraParams, SceneStatic, SceneTables, camera_to_torch,
                      compile_camera, compile_scene, tables_to_torch)
from .library import ACCEPTANCE, BUILDERS, get_scene
