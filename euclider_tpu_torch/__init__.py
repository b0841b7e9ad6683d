"""euclider_tpu_torch: the PyTorch + CUDA port of euclider_tpu.

The JAX package ``euclider_tpu`` beside it is the reference.  This package
imports torch and never jax: it carries its own copy of the numpy scene front
end (``scene/``), a plain batched-torch version of the trace loop
(``ops/trace.py``) and the hand-written CUDA kernel that replaces the Pallas
forward megakernel (``ops/cuda_kernel.py`` + ``csrc/trace_fwd.cu``), and
the differentiable render and training step on the hand-written backward
kernels that replace the Pallas backward kernels (``ops/cuda_bwd.py`` +
``csrc/trace_bwd.cu``, ``csrc/trace_seg.cu``; plain version
``ops/vjp.py``; ``train/``).  Both
kernels march warped and expression space; expressions run on a per-thread
VM (``csrc/trace_common.cuh``), and their gradients reach the expression
parameters and the scene ``time``.

    import euclider_tpu_torch as et
    sc = et.get_scene("config2_mirror_glass")
    static, tables = et.compile_scene(sc)
    tables = et.tables_to_torch(tables, "cuda")
    cam = et.camera_to_torch(et.compile_camera(sc.camera), "cuda")
    img = et.render_image(static, tables, cam, 720, 1280)   # [720, 1280, 3]
    img = et.render_image_diff(static, tables, cam, 720, 1280)  # autograd

The viewer (``viewer/simulation.py``: the frame loop, double-buffered to
the host; ``viewer/terminal.py``: the terminal display), the camera's pose
updates (``models/camera.py``) and the meters (``utils/profiling.py``)
drive the same render.  ``parallel/`` shards the frame's rows over the
ranks of a ``torch.distributed`` group (one process a device) for the
render and the training step (``train/inverse.py``'s ``mesh``);
``utils/checkpointing.py`` saves and restores parameters.  The plain
render computes in the tables' dtype: ``cast_tables``/``cast_camera`` and
``tables_to_torch(..., dtype=torch.float64)`` give the float64 path.  The
CUDA kernels take such tables too and compute in float32, as the Pallas
kernels do, with gradients in the tables' dtype.
"""
from .scene import ir
from .scene.compile import (CameraParams, SceneStatic, SceneTables,
                            camera_to_torch, cast_camera, cast_tables,
                            compile_camera, compile_scene, tables_to_torch)
from .ops.cuda_bwd import render_image_diff
from .ops.trace import render_rays
from .scene.library import ACCEPTANCE, get_scene
from .train.inverse import (InverseParams, make_fused_value_and_grad,
                            make_loss_fn, make_train_step)


def render_image(static, tables, cam, H: int, W: int, time=0.0, y0: int = 0,
                 rows: int | None = None):
    """Render rows [y0, y0 + rows) of the H x W frame -> [rows or H, W, 3]
    on the tables' device.  CUDA tensors go through the CUDA kernel, which
    casts tables and camera of any floating dtype to float32 and returns
    float32, as the Pallas kernel does; CPU tensors through the plain torch
    version, in the tables' dtype.  A float64 render on the card is
    ``ops.trace.render_image``."""
    if tables.surf_color.device.type == "cuda":
        from .ops.cuda_kernel import render_image_cuda
        return render_image_cuda(static, tables, cam, H, W, time, y0, rows)
    from .ops.trace import render_image as render_plain
    return render_plain(static, tables, cam, H, W, time, y0, rows)
