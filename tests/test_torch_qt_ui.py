"""The port's Qt editor (michigan_tpu_torch/demo/qt_ui.py) against the JAX
package's (michigan_tpu/demo/qt_ui.py), both under tests/test_qt_ui.py's fake
PyQt5 (this container has none).

The same scripted session (Open Tag / Ref / Mask / Orient, strokes in the
Hair, BackGround and Brush modes, undo, Clear, both radio pairs) drives a
window of each package, each with a recording engine and a recording
stroke_to_orient: every edit call must carry the same arguments.  Then the
port's window with its real DemoEngine on the CPU: a stroke edit through the
window equals DemoEngine.edit called directly, bit for bit.  Last, the entry
point: ``python -m michigan_tpu_torch.demo`` starts the editor, and runs the
headless edit under MICHIGAN_HEADLESS=1 or without PyQt5.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_qt_ui import _Event, fake_qt  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "datasets", "FFHQ_demo")
TINY = ["--gpu_ids", "-1", "--crop_size", "128", "--load_size", "128", "--ngf", "8",
        "--init_type", "none", "--demo_data_dir", DEMO]
PORT_UI = "michigan_tpu_torch.demo.qt_ui"


@pytest.fixture(autouse=True, scope="module")
def one_thread_subnormals_flushed():
    """The port's CPU work in one thread (beside the other workers of a
    parallel run), with subnormal floats flushed to zero: the untrained
    inpainters' attention softmax underflows into subnormals, on which the
    CPU's matmuls run ~8x slower.  Each comparison here runs both of its
    sides under the same setting.  Both restored after the module."""
    n = torch.get_num_threads()
    flushed = torch.tensor([1e-39]).mul(1.0).item() == 0.0
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(flushed)
    torch.set_num_threads(n)


@pytest.fixture
def qt(fake_qt):  # noqa: F811
    """The fake PyQt5, with the port's UI module imported afresh under it."""
    sys.modules.pop(PORT_UI, None)
    yield
    sys.modules.pop(PORT_UI, None)


class RecordingEngine:
    """Records every edit's arguments, as arrays; answers a blank result."""

    def __init__(self, opt, device=None, **_):
        self.opt, self.device = opt, torch.device("cpu") if device is None else device
        self.calls = []

    def edit(self, ref_label_path, label, mask_orient, orient, ref_img, tag_img,
             orient_stroke=None, mask_stroke=None, mask_hole=None, inpaint_mode="ref"):
        arr = lambda a: None if a is None else np.array(a)
        self.calls.append({
            "ref_label_path": ref_label_path, "label": arr(label), "mask_orient": arr(mask_orient),
            "orient": arr(orient), "ref_img": arr(ref_img), "tag_img": arr(tag_img),
            "orient_stroke": arr(orient_stroke), "mask_stroke": arr(mask_stroke),
            "mask_hole": arr(mask_hole), "inpaint_mode": inpaint_mode})
        return np.zeros((8, 8, 3), np.uint8), None, 0.01


def demo_opts():
    from michigan_tpu.config import Options as JOptions
    from michigan_tpu_torch.config import Options

    kw = dict(isTrain=False, demo_data_dir=DEMO, gpu_ids="-1")
    return JOptions(**kw).finalize(), Options(**kw).finalize()


def hair_points():
    label = np.array(Image.open(os.path.join(DEMO, "labels", "67172.png")))
    ys, xs = np.nonzero(label)
    return int(ys.mean()), int(xs.min()), int(xs.max()), label


def drag(scene, points):
    scene.mousePressEvent(_Event(*points[0]))
    for p in points[1:]:
        scene.mouseMoveEvent(_Event(*p))
    scene.mouseReleaseEvent(_Event(*points[-1]))


def scripted_session(win, ui, monkeypatch, tmp_path):
    """One user's session; edit() at each numbered point."""
    def pick(*parts):
        path = os.path.join(DEMO, *parts)
        monkeypatch.setattr(ui.QFileDialog, "getOpenFileName", lambda *a, **k: (path, ""))

    y, x0, x1, _ = hair_points()
    xm = (x0 + x1) // 2
    win.edit()                                        # no tag or ref yet: nothing
    pick("images", "67172.jpg")
    win.open_target()
    pick("images", "59144.jpg")
    win.open_reference()
    win.edit()                                        # 1 ref mode, reference mask
    win.set_mode(ui.MODE_HAIR)
    for _ in range(3):
        win.step_brush(+1)
    drag(win.scene, [(x0 - 30, y - 40), (xm, y - 60), (x1 + 20, y - 40)])
    win.mask_radio_edit.setChecked(True)
    win.edit()                                        # 2 edited mask with hair added
    win.set_mode(ui.MODE_BG)
    for _ in range(20):
        win.step_brush(+1)
    for dy in (0, 10, 20):
        drag(win.scene, [(x0, y + dy), (x1, y + dy)])
    win.edit()                                        # 3 hair removed: the recon tag
    win.undo()
    win.edit()                                        # 4 one erasure undone
    win.mask_radio_ref.setChecked(True)
    win.edit()                                        # 5 reference mask again
    win.orient_radio_edit.setChecked(True)
    win.set_mode(ui.MODE_STROKE)
    for _ in range(12):
        win.step_brush(-1)
    drag(win.scene, [(x0 + 10, y - 20), (xm, y), (x1 - 10, y + 15)])
    win.edit()                                        # 6 stroke mode
    win.mask_radio_edit.setChecked(True)
    win.edit()                                        # 7 stroke mode, edited mask
    pick("labels", "59144.png")
    win.open_mask()
    win.edit()                                        # 8 the custom mask
    pick("orients", "60429_orient_dense.png")
    win.open_orient()
    win.edit()                                        # 9 the custom orientation
    win.orient_radio_ref.setChecked(True)
    win.edit()                                        # 10 ref mode, custom orientation
    win.clear()
    win.edit()                                        # 11 no strokes
    monkeypatch.chdir(tmp_path)
    win.save()


def run_window(ui, monkeypatch, tmp_path, opt, to_numpy):
    strokes = []

    def fake_stroke_to_orient(stroke):
        strokes.append(to_numpy(stroke).copy())
        return stroke[..., None].repeat(1, 1, 3).float() * 7.0 if torch.is_tensor(stroke) \
            else np.repeat(stroke[..., None], 3, -1).astype(np.float32) * 7.0

    monkeypatch.setattr(ui, "DemoEngine", RecordingEngine)
    monkeypatch.setattr(ui, "stroke_to_orient", fake_stroke_to_orient)
    tmp_path.mkdir()
    win = ui.DemoWindow(opt)
    scripted_session(win, ui, monkeypatch, tmp_path)
    return win, strokes


def test_edit_calls_match_the_jax_window(qt, monkeypatch, tmp_path):
    from michigan_tpu.demo import qt_ui as jax_ui
    from michigan_tpu_torch.demo import qt_ui as port_ui

    jax_opt, port_opt = demo_opts()
    jwin, jstrokes = run_window(jax_ui, monkeypatch, tmp_path / "jax", jax_opt, np.asarray)
    pwin, pstrokes = run_window(port_ui, monkeypatch, tmp_path / "port", port_opt,
                                lambda t: t.cpu().numpy())
    jcalls, pcalls = jwin.engine.calls, pwin.engine.calls
    assert len(pcalls) == len(jcalls) == 11
    assert [c["inpaint_mode"] for c in pcalls] == ["ref"] * 5 + ["stroke"] * 4 + ["ref"] * 2
    for i, (p, j) in enumerate(zip(pcalls, jcalls)):
        assert p.keys() == j.keys()
        for k in p:
            if isinstance(p[k], np.ndarray) or isinstance(j[k], np.ndarray):
                np.testing.assert_array_equal(p[k], j[k], err_msg=f"call {i + 1}: {k}")
            else:
                assert p[k] == j[k], (i + 1, k)
    assert len(pstrokes) == len(jstrokes) == 4
    for p, j in zip(pstrokes, jstrokes):
        np.testing.assert_array_equal(p, j)
    assert any(s.any() for s in pstrokes)
    # the session reached every branch: the recon tag (3), a custom mask (8)
    recon = np.array(Image.open(os.path.join(DEMO, "images_recon", "67172.jpg")))
    np.testing.assert_array_equal(pcalls[2]["tag_img"], recon)
    assert not np.array_equal(pcalls[1]["label"], pcalls[0]["label"])
    assert pcalls[7]["label"].max() == 1 and not np.array_equal(pcalls[7]["label"],
                                                                 pcalls[6]["label"])
    assert not np.array_equal(pcalls[8]["orient"], pcalls[7]["orient"])
    assert os.path.exists(tmp_path / "port" / "inference_samples" / "demo_edit.jpg")
    assert not any(pwin.scene.strokes.values())


def test_brush_steps_within_1_and_15_and_radios_pair(qt, monkeypatch):
    from michigan_tpu_torch.demo import qt_ui

    monkeypatch.setattr(qt_ui, "DemoEngine", RecordingEngine)
    win = qt_ui.DemoWindow(demo_opts()[1])
    assert win.scene.size == qt_ui.DEFAULT_BRUSH == 6
    win.step_brush(+1)
    assert win.scene.size == 7
    for _ in range(10):
        win.step_brush(-1)
    assert win.scene.size == 1
    for _ in range(20):
        win.step_brush(+1)
    assert win.scene.size == 15
    win.step_brush(-1)
    drag(win.scene, [(0, 0), (3, 3)])
    assert win.scene.strokes[qt_ui.MODE_HAIR][-1][1] == 14
    assert win.mask_radio_ref.isChecked() and win.orient_radio_ref.isChecked()
    win.mask_radio_edit.setChecked(True)
    assert not win.mask_radio_ref.isChecked() and win.orient_radio_ref.isChecked()
    win.orient_radio_edit.setChecked(True)
    assert not win.orient_radio_ref.isChecked() and win.mask_radio_edit.isChecked()
    win.mask_radio_ref.setChecked(True)
    assert not win.mask_radio_edit.isChecked() and win.orient_radio_edit.isChecked()


def test_stroke_edit_through_the_window_equals_the_engine(qt, monkeypatch, tmp_path):
    """The port's real DemoEngine on the CPU (tiny width): the window's
    stroke edit equals DemoEngine.edit on arguments built here from the same
    stroke, bit for bit."""
    import cv2

    from michigan_tpu_torch.config import demo_options
    from michigan_tpu_torch.demo import qt_ui
    from michigan_tpu_torch.demo.engine import dilate_hole, stroke_to_orient

    torch.manual_seed(0)
    opt = demo_options(TINY + ["--checkpoints_dir", str(tmp_path)])
    win = qt_ui.DemoWindow(opt)
    assert win.engine.device == torch.device("cpu")
    for name, opener in (("67172", win.open_target), ("59144", win.open_reference)):
        path = os.path.join(DEMO, "images", name + ".jpg")
        monkeypatch.setattr(qt_ui.QFileDialog, "getOpenFileName", lambda *a, **k: (path, ""))
        opener()
    y, x0, x1, label = hair_points()
    points = [(x0 + 10, y - 20), ((x0 + x1) // 2, y), (x1 - 10, y + 15)]
    win.orient_radio_edit.setChecked(True)
    win.set_mode(qt_ui.MODE_STROKE)
    drag(win.scene, points)
    win.edit()

    stroke = np.zeros(label.shape, np.uint8)
    for a, b in zip(points[:-1], points[1:]):
        cv2.line(stroke, a, b, 1, qt_ui.DEFAULT_BRUSH)
    stroke = stroke * label
    assert stroke.sum() > 100
    hole = dilate_hole(stroke, 50) * label
    orient = np.array(Image.open(os.path.join(DEMO, "orients", "67172_orient_dense.png")))
    result, orient_rgb, _ = win.engine.edit(
        os.path.join(DEMO, "labels", "59144.png"), label, label, orient,
        Image.open(os.path.join(DEMO, "images", "59144.jpg")),
        Image.open(os.path.join(DEMO, "images", "67172.jpg")),
        orient_stroke=stroke_to_orient(torch.from_numpy(stroke)).numpy(), mask_stroke=stroke,
        mask_hole=hole, inpaint_mode="stroke")
    assert result.shape == (128, 128, 3) and result.dtype == np.uint8
    np.testing.assert_array_equal(win.result, result)
    np.testing.assert_array_equal(win.orient_rgb, orient_rgb)


def test_module_entry_starts_the_editor(qt, monkeypatch):
    """python -m michigan_tpu_torch.demo with PyQt5 present: a window over
    the engine on the device --gpu_ids names, shown, and the app's loop."""
    import michigan_tpu_torch.demo.engine as engine_mod

    shown, engines = [], []

    class App:
        def __init__(self, argv):
            pass

        def exec_(self):
            shown.append("exec_")
            return 0

    class Engine(RecordingEngine):
        def __init__(self, opt, device=None, **kw):
            super().__init__(opt, device, **kw)
            engines.append(self)

    monkeypatch.setattr(sys.modules["PyQt5.QtWidgets"], "QApplication", App)
    monkeypatch.setattr(engine_mod, "DemoEngine", Engine)
    monkeypatch.delenv("MICHIGAN_HEADLESS", raising=False)
    monkeypatch.setattr(sys, "argv", ["michigan_tpu_torch.demo", *TINY])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("michigan_tpu_torch.demo", run_name="__main__")
    assert e.value.code == 0 and shown == ["exec_"]
    assert len(engines) == 1 and engines[0].device == torch.device("cpu")
    assert engines[0].opt.demo_data_dir == DEMO and engines[0].opt.crop_size == 128


def test_module_entry_runs_headless(qt, monkeypatch, tmp_path, capsys):
    """Under MICHIGAN_HEADLESS=1 the scripted edit runs (the real engine,
    tiny width) and the editor is not imported; without PyQt5 the entry
    says so and runs the same edit."""
    out = tmp_path / "edit.jpg"
    argv = ["--stroke", "--out", str(out), "--checkpoints_dir", str(tmp_path), *TINY]
    monkeypatch.setenv("MICHIGAN_HEADLESS", "1")
    monkeypatch.setattr(sys, "argv", ["michigan_tpu_torch.demo", *argv])
    runpy.run_module("michigan_tpu_torch.demo", run_name="__main__")
    assert PORT_UI not in sys.modules
    stdout = capsys.readouterr().out
    assert f"saved {out}" in stdout and "PyQt5 not available" not in stdout
    assert Image.open(out).size == (128, 128)

    from michigan_tpu_torch.demo import __main__ as entry

    ran = []
    monkeypatch.delenv("MICHIGAN_HEADLESS")
    monkeypatch.setitem(sys.modules, "PyQt5", None)  # import PyQt5 raises ImportError
    monkeypatch.setattr(entry, "run_headless", lambda a: ran.append(a))
    entry.main(argv)
    assert ran == [argv] and "PyQt5 not available" in capsys.readouterr().out
    assert PORT_UI not in sys.modules
