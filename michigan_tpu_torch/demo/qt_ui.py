"""The PyQt5 editor over the port's DemoEngine (counterpart of
michigan_tpu/demo/qt_ui.py; reference demo.py's Ex widget and ui/ package).

Imports PyQt5 at import, as the JAX package's module does: only
``python -m michigan_tpu_torch.demo`` checks whether it exists.  The surface
(ui/ui4.py:8-248, ui/mouse_event.py, demo.py:42-518):

  - five fixed-size QGraphicsViews: paintable hair mask 512^2, orientation
    512^2, result 512^2, tag 256^2, ref 256^2 (ui4.py:13-27)
  - Open Ref / Open Tag / Open Mask / Open Orient (demo.py:108-293)
  - Hair / BackGround / Brush (stroke) paint modes with per-mode stroke
    history and undo (ui/mouse_event.py), Clear (demo.py:446-452)
  - mask and orient brush +/- stepping by 1 within [1, 15]
    (demo.py:301-307, 500-507)
  - two radio pairs: Hair Mask Reference|Edited, Hair Orientation
    Reference|Edited, which choose the edit's sources (demo.py:336-361)

The engine runs on the device --gpu_ids names (the card unless -1 asks for
the CPU): the stroke's orientation through the DoG bank there
(filterbank_orientation on a card), then the edit's forward and encode.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch
from PIL import Image
from PyQt5.QtCore import Qt
from PyQt5.QtGui import QImage, QPen, QPixmap
from PyQt5.QtWidgets import (
    QApplication,
    QFileDialog,
    QGraphicsScene,
    QGraphicsView,
    QHBoxLayout,
    QPushButton,
    QRadioButton,
    QVBoxLayout,
    QWidget,
)

from michigan_tpu_torch.demo.engine import (
    DemoEngine,
    dilate_hole,
    engine_device,
    select_tag_image,
    stroke_to_orient,
)

MODE_BG, MODE_HAIR, MODE_STROKE = 0, 1, 2

# reference brush stepping: +-1 within [1, 15] (demo.py:301-307)
BRUSH_MIN, BRUSH_MAX = 1, 15
DEFAULT_BRUSH = 6


class PaintScene(QGraphicsScene):
    """Stroke capture with per-mode history (reference ui/mouse_event.py)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.mode = MODE_HAIR
        self.size = DEFAULT_BRUSH
        self.strokes = {MODE_BG: [], MODE_HAIR: [], MODE_STROKE: []}
        self._current = None

    def mousePressEvent(self, event):
        self._current = [event.scenePos()]

    def mouseMoveEvent(self, event):
        if self._current is None:
            return
        self._current.append(event.scenePos())
        pen = QPen(Qt.green if self.mode == MODE_STROKE
                   else (Qt.white if self.mode == MODE_HAIR else Qt.black))
        pen.setWidth(self.size)
        a, b = self._current[-2], self._current[-1]
        self.addLine(a.x(), a.y(), b.x(), b.y(), pen)

    def mouseReleaseEvent(self, event):
        if self._current:
            self.strokes[self.mode].append((list(self._current), self.size))
        self._current = None

    def undo(self):
        if self.strokes[self.mode]:
            self.strokes[self.mode].pop()

    def reset(self):
        for mode in self.strokes:
            self.strokes[mode].clear()

    def rasterize(self, shape):
        """Strokes -> a binary uint8 mask per mode (reference demo.py:431-435)."""
        import cv2

        masks = {}
        for mode, strokes in self.strokes.items():
            m = np.zeros(shape, np.uint8)
            for pts, size in strokes:
                for a, b in zip(pts[:-1], pts[1:]):
                    cv2.line(m, (int(a.x()), int(a.y())), (int(b.x()), int(b.y())), 1, size)
            masks[mode] = m
        return masks


def _np_to_pixmap(arr: np.ndarray) -> QPixmap:
    arr = np.ascontiguousarray(arr.astype(np.uint8))
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    return QPixmap.fromImage(QImage(arr.tobytes(), w, h, 3 * w, QImage.Format_RGB888))


def orient_to_rgb_u8(orient: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dense orient [0,255] -> the demo's RGB view (demo.py:238-246):
    ((cos 2t + 1) / 2, (sin 2t + 1) / 2, 0.5) inside the mask, uint8."""
    t = orient.astype(np.float64) / 255.0 * math.pi
    rgb = np.zeros(orient.shape + (3,))
    rgb[..., 0] = (np.cos(2 * t) + 1) / 2
    rgb[..., 1] = (np.sin(2 * t) + 1) / 2
    rgb[..., 2] = 0.5
    rgb *= mask[..., None]
    return np.uint8(rgb * 255.0)


def _first_channel(m: np.ndarray) -> np.ndarray:
    return m[..., 0] if m.ndim == 3 else m


class DemoWindow(QWidget):
    """The reference editor: five fixed views, the mode and brush buttons,
    and the two Reference|Edited radio pairs that choose what `edit` hands
    the engine."""

    def __init__(self, opt):
        super().__init__()
        self.opt = opt
        self.engine = DemoEngine(opt, engine_device(opt))
        self.tag_name = None
        self.ref_name = None
        # Open Mask / Open Orient overrides (demo.py:218-293); None uses the
        # tag's own label and dense orientation
        self.custom_mask = None
        self.custom_orient = None
        self.custom_orient_mask = None
        self.setWindowTitle("MichiGAN demo")

        # five fixed-size views (ui4.py:13-27)
        self.scene = PaintScene()
        self.orient_scene = QGraphicsScene()
        self.result_scene = QGraphicsScene()
        self.tag_scene = QGraphicsScene()
        self.ref_scene = QGraphicsScene()
        views = []
        for scene, side in ((self.scene, 512), (self.orient_scene, 512),
                            (self.result_scene, 512), (self.tag_scene, 256),
                            (self.ref_scene, 256)):
            view = QGraphicsView(scene)
            view.setFixedSize(side, side)
            views.append(view)
        self.view, self.orient_view, self.result_view, self.tag_view, self.ref_view = views

        # radio pairs (ui4.py:151-178), Reference checked.  Qt's
        # autoExclusive would make the four radios under one parent a single
        # group, so each pair is kept exclusive by hand
        self.mask_radio_ref = QRadioButton("Reference")
        self.mask_radio_edit = QRadioButton("Edited")
        self.orient_radio_ref = QRadioButton("Reference")
        self.orient_radio_edit = QRadioButton("Edited")
        radios = (self.mask_radio_ref, self.mask_radio_edit,
                  self.orient_radio_ref, self.orient_radio_edit)
        for r in radios:
            r.setAutoExclusive(False)
        self.mask_radio_ref.setChecked(True)
        self.orient_radio_ref.setChecked(True)

        def pair(a, b):
            a.toggled.connect(lambda *_: b.setChecked(not a.isChecked()))
            b.toggled.connect(lambda *_: a.setChecked(not b.isChecked()))

        pair(self.mask_radio_ref, self.mask_radio_edit)
        pair(self.orient_radio_ref, self.orient_radio_edit)

        buttons = [                                            # ui4.py's
            ("Save", self.save),                               # pushButton0
            ("Edit", self.edit),                               # pushButton
            ("Open Ref", self.open_reference),                 # pushButton_2
            ("Open Tag", self.open_target),                    # pushButton_3
            ("Open Mask", self.open_mask),                     # pushButton_4
            ("Open Orient", self.open_orient),                 # pushButton_5
            ("Hair", lambda: self.set_mode(MODE_HAIR)),        # pushButton_6
            ("BackGround", lambda: self.set_mode(MODE_BG)),    # pushButton_7
            ("Mask +", lambda: self.step_brush(+1)),           # pushButton_8
            ("Mask -", lambda: self.step_brush(-1)),           # pushButton_9
            ("Clear", self.clear),                             # pushButton_10
            ("Brush", lambda: self.set_mode(MODE_STROKE)),     # pushButton_11
            ("Orient +", lambda: self.step_brush(+1)),         # pushButton_13
            ("Orient -", lambda: self.step_brush(-1)),         # pushButton_14
            ("Undo", self.undo),
        ]
        btn_col = QVBoxLayout()
        for name, cb in buttons:
            b = QPushButton(name)
            b.clicked.connect(cb)
            btn_col.addWidget(b)
        for r in radios:
            btn_col.addWidget(r)
        thumbs = QVBoxLayout()
        thumbs.addWidget(self.tag_view)
        thumbs.addWidget(self.ref_view)
        lay = QHBoxLayout(self)
        for view in (self.view, self.orient_view, self.result_view):
            lay.addWidget(view)
        lay.addLayout(thumbs)
        lay.addLayout(btn_col)
        self.result = None
        self.orient_rgb = None

    # ------------------------------------------------------------------ modes
    def set_mode(self, mode):
        self.scene.mode = mode

    def step_brush(self, direction):
        """+-1 within [1, 15] (demo.py increase / decrease)."""
        self.scene.size = max(BRUSH_MIN, min(BRUSH_MAX, self.scene.size + direction))

    def undo(self):
        self.scene.undo()

    def _image_path(self, name):
        return os.path.join(self.opt.demo_data_dir, "images", name + ".jpg")

    def clear(self):
        """Drop every stroke and repaint the tag image (demo.py:446-452)."""
        self.scene.reset()
        self.scene.clear()
        if self.tag_name:
            self.scene.addPixmap(QPixmap(self._image_path(self.tag_name)))

    # ------------------------------------------------------------------ open
    def _load(self, title):
        path, _ = QFileDialog.getOpenFileName(self, title, self.opt.demo_data_dir)
        return path or None

    def open_target(self):
        path = self._load("target image")
        if path:
            self.tag_name = os.path.splitext(os.path.basename(path))[0]
            self.custom_mask = self.custom_orient = self.custom_orient_mask = None
            self.scene.reset()
            self.scene.clear()
            self.scene.addPixmap(QPixmap(self._image_path(self.tag_name)))
            self.tag_scene.clear()
            self.tag_scene.addPixmap(QPixmap(self._image_path(self.tag_name)))

    def open_reference(self):
        path = self._load("reference image")
        if path:
            self.ref_name = os.path.splitext(os.path.basename(path))[0]
            self.ref_scene.clear()
            self.ref_scene.addPixmap(QPixmap(self._image_path(self.ref_name)))

    def open_mask(self):
        """A custom hair mask in place of the tag's label (demo.py:263-293)."""
        path = self._load("hair mask")
        if path:
            self.custom_mask = (_first_channel(np.array(Image.open(path))) > 0).astype(np.uint8)
            self.scene.clear()
            self.scene.addPixmap(_np_to_pixmap(self.custom_mask * 255))

    def open_orient(self):
        """A custom dense orientation map `<name>_orient_dense.png`, with its
        sample's label as the orientation mask (demo.py:218-261)."""
        path = self._load("dense orientation")
        if path:
            name = os.path.basename(path)
            stem = name[:-17] if name.endswith("_orient_dense.png") else \
                os.path.splitext(name)[0]
            self.custom_orient = np.array(Image.open(path).convert("L"), np.uint8)
            label_path = os.path.join(self.opt.demo_data_dir, "labels", stem + ".png")
            if os.path.exists(label_path):
                m = _first_channel(np.array(Image.open(label_path)))
                self.custom_orient_mask = (m > 0).astype(np.uint8)
            else:
                self.custom_orient_mask = (self.custom_orient > 0).astype(np.uint8)
            self.orient_scene.clear()
            self.orient_scene.addPixmap(_np_to_pixmap(
                orient_to_rgb_u8(self.custom_orient, self.custom_orient_mask)))

    # ------------------------------------------------------------------ edit
    def edit(self):
        """The reference dispatch (demo.py:310-361): the radio pairs choose
        the mask and the orientation; an edited mask that removes hair takes
        the reconstructed tag image."""
        if not (self.tag_name and self.ref_name):
            return
        d = self.opt.demo_data_dir
        tag_img = Image.open(self._image_path(self.tag_name))
        ref_img = Image.open(self._image_path(self.ref_name))
        tag_label = self.custom_mask if self.custom_mask is not None else \
            np.array(Image.open(os.path.join(d, "labels", self.tag_name + ".png")))
        tag_label = _first_channel(tag_label)
        tag_orient = self.custom_orient if self.custom_orient is not None else np.array(
            Image.open(os.path.join(d, "orients", self.tag_name + "_orient_dense.png")))
        orient_mask = self.custom_orient_mask if self.custom_orient_mask is not None \
            else tag_label

        masks = self.scene.rasterize(tag_label.shape)
        mask_m = np.clip(tag_label + masks[MODE_HAIR], 0, 1) * (1 - masks[MODE_BG])
        use_ref_mask = self.mask_radio_ref.isChecked()
        label = tag_label if use_ref_mask else mask_m

        # an edited mask that removes hair: the reconstructed tag supplies
        # the exposed background (demo.py:330-333)
        recon_path = os.path.join(d, "images_recon", self.tag_name + ".jpg")
        recon = Image.open(recon_path) if os.path.exists(recon_path) else None
        tag_img = select_tag_image(tag_img, recon, tag_label, mask_m,
                                   use_reference_mask=use_ref_mask)

        ref_label_path = os.path.join(d, "labels", self.ref_name + ".png")
        if self.orient_radio_edit.isChecked():
            # Edited orientation: the SIG stroke path (demo.py:346-361); the
            # DoG bank runs on the engine's device
            stroke = masks[MODE_STROKE] * label
            hole = dilate_hole(stroke, 50) * label
            orient_stroke = stroke_to_orient(
                torch.from_numpy(stroke).to(self.engine.device)).cpu().numpy()
            self.result, self.orient_rgb, _ = self.engine.edit(
                ref_label_path, label, orient_mask, tag_orient, ref_img, tag_img,
                orient_stroke=orient_stroke, mask_stroke=stroke, mask_hole=hole,
                inpaint_mode="stroke")
        else:
            self.result, self.orient_rgb, _ = self.engine.edit(
                ref_label_path, label, orient_mask, tag_orient, ref_img, tag_img,
                inpaint_mode="ref")
        self.result_scene.clear()
        self.result_scene.addPixmap(_np_to_pixmap(self.result))
        if self.orient_rgb is not None:
            # the inpainted orientation in the orientation view
            self.orient_scene.clear()
            self.orient_scene.addPixmap(_np_to_pixmap(np.clip(np.asarray(self.orient_rgb),
                                                              0, 255)))

    def save(self):
        if self.result is not None:
            os.makedirs("./inference_samples", exist_ok=True)
            Image.fromarray(self.result).save("./inference_samples/demo_edit.jpg")


def launch(argv=None):
    from michigan_tpu_torch.config import demo_options

    opt = demo_options(argv)
    app = QApplication(sys.argv)
    win = DemoWindow(opt)
    win.show()
    sys.exit(app.exec_())
