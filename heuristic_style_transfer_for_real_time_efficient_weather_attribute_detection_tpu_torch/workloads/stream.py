"""Real-time streaming inference of the port (camera / video modes).

The per-frame step runs at batch 1 on the device: the raw uint8 frame goes
to the card as it is, then the forward, the masked softmax and the stacked
Kalman update (``ops/kalman.py``) run there, and the probabilities start
copying back to the host at once.  The host loop of :func:`run_camera` only
decodes, crops and overlays.

For the shipped PMG the forward is two kernels: the fused trunk + Gram
(``ops.cuda_kernels.fused_trunk_gram``) and the fused head
(``ops.cuda_kernels.fused_head``) on a compressed ``fold_head_weights``
tree.  For RTM the default forward runs on the int8 ``fold_stream_weights``
tree, whose fold product is the ``dequant_matvec`` kernel.  PM runs its
generic forward on the normalized frame.  The stream runs in float32 or
bf16 (``dtype``), as the JAX package's does.  Parity features: threshold ->
Unknown labels, translucent text box overlay, XVID recording at 20 FPS,
per-frame latency -> times_camera.json; keys r (record), f (fullscreen), q
(quit); headless runs with no display.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import TaskSpec
from ..engine.checkpoint import to_device
from ..engine.executor import class_mask, masked_softmax
from ..models import get_family
from ..ops import cuda_kernels, kalman, kernel_select
from ..ops.nn import cast_tree
from ..ops.preprocess import normalize_uint8, normalize_uint8_packed, s2d_pack

_TRUNK_KERNELS = ("auto", "fused", "packed", "generic", "folded", "folded_q8")
_ROUTES = {
    "pmg": ("fused", "packed", "generic"),
    "rtm": ("generic", "folded", "folded_q8"),
    "pm": ("generic",),
}
# PMG head treatments on the fused route: the exact float32 head, the
# compressed folds through the plain head, or the fused head kernel on them.
_HEAD_FOLDS = ("f32", "bf16", "q8", "fused_bf16", "fused_q8")


class PendingProbs:
    """One submitted frame's probabilities [T, Kmax], in flight.

    The host copy was started when the step was enqueued;
    ``np.asarray(handle)`` (or :meth:`numpy`) waits for it and returns the
    host array.
    """

    def __init__(self, host: torch.Tensor, event: Optional["torch.cuda.Event"]):
        self._host = host
        self._event = event

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


class StreamPredictor:
    """Per-frame predictor with optional Kalman smoothing (PMG, RTM and PM).

    PMG routes (``trunk_kernel``):

    - ``"fused"``: the fused trunk + Gram kernel, then the head chosen by
      ``head_fold``: ``"f32"`` (exact head), ``"bf16"`` / ``"q8"``
      (``fold_head_weights`` through the plain head), ``"fused_bf16"`` /
      ``"fused_q8"`` (the fused head kernel on that fold).  Batch-norm specs
      with a ``[k=s p0]x2 + 1x1`` plan and no SE only.
    - ``"packed"``: ``pmg.apply_packed``, the stem kernel on the raw frame,
      then the batch path's ops and Gram kernel at batch 1.
    - ``"generic"``: ``pmg.apply`` on the normalized frame.
    - ``"auto"``: where the fused kernel takes the spec, the route that
      ``ops.kernel_select`` records as faster on this predictor's card (op
      ``fused_trunk_gram``: ``"fused"`` or ``"packed"``), and on the fused
      route the recorded head fold (op ``pmg_head_fold``); with no record
      (the CPU), ``"fused"`` with ``head_fold="fused_bf16"``.  Where the
      fused kernel does not take the spec, ``"packed"`` where the first
      block is non-overlapping, else ``"generic"``.

    RTM routes:

    - ``"generic"``: ``rtm.apply`` on the normalized frame;
    - ``"folded"``: ``rtm.apply_stream`` on a float32
      ``fold_stream_weights`` tree (the fold product is a plain ``bmm``);
    - ``"folded_q8"``: the same on the int8 fold, whose product is the
      ``dequant_matvec`` kernel.  The folded routes pack the frame on the
      device (k = 2) and run the packed 4x4 stem.
    - ``"auto"``: where ``spec.use_attention``, the route recorded as
      fastest on this predictor's card (op ``rtm_stream_folded``), with no
      record ``"folded_q8"``; else ``"generic"``.

    PM has one route, ``"generic"`` (``pm.apply`` on the normalized
    frame), which ``"auto"`` picks, as the JAX package's generic uint8 step.

    ``params`` may be a ready ``fold_stream_weights`` tree for the folded
    routes (of the same kind and type as the route and ``dtype``), so a
    fold built once, on the card, can be reused.  ``head_fold`` applies to
    PMG's fused route only.

    ``dtype`` (float32 or bfloat16) is the JAX package's: the ``fused``
    route ignores it (its trunk fold and head fold carry their own types),
    so its bf16 predictor equals the float32 one bit for bit; ``packed``
    runs ``apply_packed`` in bf16 on a bf16 copy of the params and its own
    bf16 stem fold, as ``Engine(dtype=bfloat16)`` does at batch 1;
    ``folded`` / ``folded_q8`` run on ``fold_stream_weights(dtype=...)``
    (on the int8 fold, ``dequant_matvec``'s bf16 mode); ``generic`` runs
    the family's ``apply`` on a bf16 copy of the params and the frame
    normalized in bf16.  The logits go to float32 before the masked softmax;
    the Kalman state stays float32.

    ``device`` defaults to the CUDA card and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels.
    """

    def __init__(self, family: str, spec, params, use_kalman: bool = False,
                 dtype: torch.dtype = torch.float32, trunk_kernel: str = "auto",
                 head_fold: str = "auto", device="cuda"):
        from ..models import pmg, rtm

        mod = get_family(family)  # raises for an unknown family
        family = family.lower()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"StreamPredictor dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if trunk_kernel not in _TRUNK_KERNELS:
            raise ValueError(f"unknown trunk_kernel {trunk_kernel!r}; expected one of {_TRUNK_KERNELS}")
        if head_fold != "auto" and head_fold not in _HEAD_FOLDS:
            raise ValueError(
                f"unknown head_fold {head_fold!r}; expected one of {_HEAD_FOLDS} or 'auto'"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StreamPredictor: no CUDA device is available; pass device='cpu' "
                "to run the plain versions on the CPU"
            )
        self.spec = spec
        self.tasks: TaskSpec = spec.tasks
        self.use_kalman = use_kalman
        self._mask = torch.as_tensor(class_mask(self.tasks), device=self.device)

        if family == "rtm":
            fusable = packable = False
            if trunk_kernel == "auto":
                route = (kernel_select.winner("rtm_stream_folded", "folded_q8", self.device)
                         if spec.use_attention else "generic")
            else:
                route = trunk_kernel
            if route in ("folded", "folded_q8") and not spec.use_attention:
                raise ValueError(f"trunk_kernel={route!r} needs an RTM spec with use_attention")
        elif family == "pm":
            fusable = packable = False
            route = "generic" if trunk_kernel == "auto" else trunk_kernel
        else:
            fusable = cuda_kernels.supports_fused_trunk_gram(spec) and spec.norm == "batch"
            packable = pmg.supports_packed_input(spec)
            if trunk_kernel == "auto":
                route = (kernel_select.winner("fused_trunk_gram", "fused", self.device) if fusable
                         else ("packed" if packable else "generic"))
            else:
                route = trunk_kernel
        if route not in _ROUTES[family]:
            raise ValueError(
                f"trunk_kernel={route!r} is not a {family.upper()} route; expected one of "
                f"{_ROUTES[family]} or 'auto'"
            )
        if route == "fused" and not fusable:
            raise ValueError(
                "trunk_kernel='fused' needs a batch-norm spec with a [k=s p0]x2 + 1x1 "
                "trunk plan and no SE"
            )
        if route == "packed" and not packable:
            raise ValueError("trunk_kernel='packed' needs a non-overlapping first trunk block")
        if head_fold != "auto" and route != "fused":
            raise ValueError(
                "head_fold applies only to the PMG fused streaming path "
                f"(trunk_kernel='fused' on a supported batch-norm spec); this predictor "
                f"runs the {route!r} route"
            )
        self.family = family
        self.route = route
        self.dtype = dtype
        self.head_fold = None
        self._mod = mod
        params = to_device(params, self.device)
        self._trunk = self._stem = None
        if route == "fused":
            self.head_fold = (kernel_select.winner("pmg_head_fold", "fused_bf16", self.device)
                              if head_fold == "auto" else head_fold)
            self._trunk = cuda_kernels.fold_trunk_gram_weights(params, spec)
            fold = self.head_fold[len("fused_"):] if self.head_fold.startswith("fused_") else self.head_fold
            if fold != "f32":
                params = pmg.fold_head_weights(params, spec, fold)
            if self.head_fold.startswith("fused_"):
                self._head = cuda_kernels.fused_head
            else:
                def head(tokens, p, spec):
                    return pmg.head_from_gram_tokens(p, tokens, spec)

                self._head = head
        elif route == "packed":
            params = cast_tree(params, dtype)
            self._stem = pmg.fold_stem(params, spec, dtype)
        elif route in ("folded", "folded_q8"):
            q8 = route == "folded_q8"
            if "attn_pq" not in params:
                params = rtm.fold_stream_weights(params, spec, dtype=dtype, quantize_fold=q8)
            elif ("attn_fold_q8" in params) != q8 or (
                    params["attn_fold_scale" if q8 else "attn_fold"].dtype != dtype):
                raise ValueError(
                    f"the given fold_stream_weights tree does not fit route {route!r} in {dtype}")
        else:
            params = cast_tree(params, dtype)
        self.params = params
        self.kstate = kalman.init_state(len(self.tasks), self.tasks.max_classes, self.device)

    def reset(self) -> None:
        self.kstate = kalman.init_state(len(self.tasks), self.tasks.max_classes, self.device)

    @torch.inference_mode()
    def step(self, x8: torch.Tensor) -> torch.Tensor:
        """One frame on the device: uint8 [1, H, W, 3] already there ->
        probs [T, Kmax] (Kalman-smoothed when ``use_kalman``), in flight."""
        from ..models import pmg, rtm

        if self.route == "fused":
            logits = self._head(cuda_kernels.fused_trunk_gram(x8, self._trunk, self.spec),
                                self.params, self.spec)
        elif self.route == "packed":
            logits, _ = pmg.apply_packed(self.params, x8, self.spec, stem=self._stem,
                                         dtype=self.dtype)
        elif self.route in ("folded", "folded_q8"):
            x = normalize_uint8_packed(s2d_pack(x8, 2), 2, self.dtype)
            logits = rtm.apply_stream(self.params, x, self.spec)
        else:
            logits, _ = self._mod.apply(self.params, normalize_uint8(x8, self.dtype), self.spec)
        probs = masked_softmax(logits.float(), self._mask)[0]
        self.kstate, smoothed = kalman.filter_update(self.kstate, probs)
        return smoothed if self.use_kalman else probs

    def submit(self, frame_u8) -> PendingProbs:
        """Enqueue one raw uint8 frame [H, W, 3] (numpy or tensor); returns
        a :class:`PendingProbs` whose host copy has already started.  A
        camera loop submits frame i+1 before materializing frame i, so
        preprocessing and display overlap the device step and the copy."""
        x = torch.as_tensor(frame_u8)
        if x.dtype != torch.uint8 or x.ndim != 3 or x.shape[-1] != 3:
            raise ValueError(
                f"expected one raw uint8 frame [H, W, 3], got {x.dtype} {tuple(x.shape)}"
            )
        probs = self.step(x.to(self.device)[None].contiguous())
        if self.device.type != "cuda":
            return PendingProbs(probs, None)
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingProbs(host, event)

    def __call__(self, frame_u8) -> np.ndarray:
        """frame_u8: [H, W, 3] uint8 (224 px) -> per-task probs [T, Kmax]."""
        return np.asarray(self.submit(frame_u8))

    def labels(self, probs: np.ndarray, prob_threshold: float):
        """[(task, label, prob)] with threshold -> "Unknown" semantics."""
        out = []
        for ti, t in enumerate(self.tasks.names):
            k = self.tasks.num_classes[ti]
            p = probs[ti, :k]
            idx = int(p.argmax())
            label = "Unknown" if p[idx] < prob_threshold else self.tasks.class_names[ti][idx]
            out.append((t, label, float(p[idx])))
        return out


def _screen_size() -> Optional[tuple]:
    """Primary-display resolution, or None when undeterminable: screeninfo
    where installed, else the stdlib Tk query."""
    try:
        from screeninfo import get_monitors

        m = get_monitors()[0]
        return int(m.width), int(m.height)
    except Exception:
        pass
    try:
        import tkinter as tk

        root = tk.Tk()
        root.withdraw()
        size = (root.winfo_screenwidth(), root.winfo_screenheight())
        root.destroy()
        return size
    except Exception:
        return None


def run_camera(
    family: str,
    spec,
    params,
    save_dir: str,
    prob_threshold: float = 0.5,
    measure_time: bool = False,
    camera_index: int = 0,
    kalman_filter: bool = False,
    save_camera_video: bool = False,
    video_path: Optional[str] = None,
    display: bool = True,
    max_frames: Optional[int] = None,
    record: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> list:
    """Camera/video streaming loop.  ``video_path`` replaces the webcam with
    a file (testable headless); returns per-frame latencies.  Needs ``cv2``,
    imported here."""
    import cv2

    predictor = StreamPredictor(family, spec, params, use_kalman=kalman_filter,
                                dtype=dtype, device=device)
    cap = cv2.VideoCapture(video_path if video_path else camera_index)
    if not cap.isOpened():
        print("Error: cannot open camera/video source")
        return []

    os.makedirs(save_dir, exist_ok=True)
    font = cv2.FONT_HERSHEY_SIMPLEX
    font_scale, thickness = 1.0, 2
    y0, y_step, pad_x, pad_y = 40, 40, 10, 10
    tasks_dict = predictor.tasks.as_dict()
    sample = [
        f"{t}: {max(cls + ['Unknown'], key=len)} (1.00)" for t, cls in tasks_dict.items()
    ]
    sizes = [cv2.getTextSize(s, font, font_scale, thickness)[0] for s in sample]
    box_right = max(w for w, _ in sizes) + 2 * pad_x
    box_top = y0 - max(h for _, h in sizes) - pad_y
    box_bottom = y0 + (len(tasks_dict) - 1) * y_step + pad_y

    if display and sys.platform.startswith("linux") and not (
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
    ):
        # cv2's Qt backend aborts the process (not a catchable cv2.error) on
        # X-less Linux: detect headless up front instead of trying the window.
        print("[camera] no display server detected; running headless")
        display = False
    screen = None
    if display:
        try:
            cv2.namedWindow("Camera", cv2.WINDOW_NORMAL)
        except cv2.error:
            display = False
    if display:
        screen = _screen_size()

    # Without a display there is no 'r' key: if the user asked for video,
    # record from the start.
    recording = record or (save_camera_video and not display)
    writer = None
    fullscreen = False
    times = []
    quit_requested = False

    def present(frame, probs) -> None:
        """Annotate, record and display one frame with its own predictions."""
        nonlocal writer, recording, fullscreen, quit_requested
        if screen is not None:
            frame = cv2.resize(frame, screen)
        lines = [
            f"{t}: {label} ({p:.2f})"
            for t, label, p in predictor.labels(probs, prob_threshold)
        ]
        overlay = frame.copy()
        cv2.rectangle(overlay, (0, box_top), (box_right, box_bottom),
                      (255, 255, 255), thickness=-1)
        cv2.addWeighted(overlay, 0.4, frame, 0.6, 0, frame)
        for i, line in enumerate(lines):
            cv2.putText(frame, line, (pad_x, y0 + i * y_step), font, font_scale,
                        (0, 255, 0), thickness, cv2.LINE_AA)

        if save_camera_video and recording:
            if writer is None:
                path = os.path.join(save_dir, f"video_{int(time.time())}.avi")
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"XVID"), 20.0,
                    (frame.shape[1], frame.shape[0]),
                )
                print("recording started:", path)
            writer.write(frame)

        if display:
            cv2.imshow("Camera", frame)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                quit_requested = True
            if key == ord("r"):
                recording = not recording
                if not recording and writer is not None:
                    writer.release()
                    writer = None
            if key == ord("f"):
                fullscreen = not fullscreen
                cv2.setWindowProperty(
                    "Camera", cv2.WND_PROP_FULLSCREEN,
                    cv2.WINDOW_FULLSCREEN if fullscreen else cv2.WINDOW_NORMAL,
                )

    # Depth-1 pipelined loop: frame i+1's capture and preprocess overlap
    # frame i's device step and result copy; each frame is still shown with
    # its own predictions, one capture interval later.  Per-frame telemetry
    # subtracts the next frame's capture + preprocess span, so
    # times_camera.json records each frame's own preprocess + residual
    # device wait.
    pending = None  # (original frame, in-flight probs, submit time)
    captured = 0
    while True:
        t_cap0 = time.time()
        ret, frame = cap.read()
        if not ret:
            break
        t0 = time.time()
        # Aspect-preserving Resize(256) + CenterCrop(224), the reference's
        # camera transform, not a distorting direct resize.
        h0, w0 = frame.shape[:2]
        scale = 256.0 / min(h0, w0)
        rs = cv2.resize(frame, (int(round(w0 * scale)), int(round(h0 * scale))),
                        interpolation=cv2.INTER_LINEAR)
        top = int(round((rs.shape[0] - 224) / 2.0))
        left = int(round((rs.shape[1] - 224) / 2.0))
        crop = rs[top: top + 224, left: left + 224]
        rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
        handle = predictor.submit(rgb)
        t_sub = time.time()
        if pending is not None:
            pframe, ph, pt0 = pending
            probs = np.asarray(ph)
            times.append(max(time.time() - pt0 - (t_sub - t_cap0), 0.0))
            present(pframe, probs)
        pending = (frame, handle, t0)
        captured += 1
        if quit_requested or (max_frames is not None and captured >= max_frames):
            break
    if pending is not None and not quit_requested:
        pframe, ph, pt0 = pending
        probs = np.asarray(ph)
        times.append(time.time() - pt0)
        present(pframe, probs)

    cap.release()
    if writer is not None:
        writer.release()
    if display:
        cv2.destroyAllWindows()
    if measure_time and times:
        with open(os.path.join(save_dir, "times_camera.json"), "w") as f:
            json.dump(times, f, indent=2)
        print(f"mean latency: {np.mean(times):.4f}s - total: {np.sum(times):.1f}s")
    return times
