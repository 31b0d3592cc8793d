"""COCO-stuff label vocabulary (the port's copy of michigan_tpu/utils/coco.py;
reference util/coco.py:7-199).

The reference keeps a 183-entry name table (index 0 = "unlabeled", then the
182 COCO-stuff categories) and exposes ``id2label(raw_id)`` with the quirk
that raw id 182 aliases back to "unlabeled" while every other raw id is
shifted up by one.  The table is standard public COCO-stuff vocabulary —
constant data carried verbatim for parity; the API around it is ours.

Used by :mod:`michigan_tpu_torch.utils.colormap` to place the perceptually
important colors (sea/sky/tree/clouds/grass) in the 182-class palette the
same way ``util/util.py:320-328`` does.
"""

from __future__ import annotations

# index 0 = unlabeled, 1..182 = COCO-stuff categories in reference order
COCO_STUFF_NAMES: tuple = (
    "unlabeled", "person", "bicycle", "car", "motorcycle",
    "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "street sign", "stop sign", "parking meter",
    "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "hat", "backpack", "umbrella", "shoe",
    "eye glasses", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "plate", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant",
    "bed", "mirror", "dining table", "window", "desk",
    "toilet", "door", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "blender", "book",
    "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush", "hair brush", "banner", "blanket", "branch",
    "bridge", "building-other", "bush", "cabinet", "cage",
    "cardboard", "carpet", "ceiling-other", "ceiling-tile", "cloth",
    "clothes", "clouds", "counter", "cupboard", "curtain",
    "desk-stuff", "dirt", "door-stuff", "fence", "floor-marble",
    "floor-other", "floor-stone", "floor-tile", "floor-wood", "flower",
    "fog", "food-other", "fruit", "furniture-other", "grass",
    "gravel", "ground-other", "hill", "house", "leaves",
    "light", "mat", "metal", "mirror-stuff", "moss",
    "mountain", "mud", "napkin", "net", "paper",
    "pavement", "pillow", "plant-other", "plastic", "platform",
    "playingfield", "railing", "railroad", "river", "road",
    "rock", "roof", "rug", "salad", "sand",
    "sea", "shelf", "sky-other", "skyscraper", "snow",
    "solid-other", "stairs", "stone", "straw", "structural-other",
    "table", "tent", "textile-other", "towel", "tree",
    "vegetable", "wall-brick", "wall-concrete", "wall-other", "wall-panel",
    "wall-stone", "wall-tile", "wall-wood", "water-other", "waterdrops",
    "window-blind", "window-other", "wood",
)

LABEL_TO_ID = {name: i for i, name in enumerate(COCO_STUFF_NAMES)}


def id2label(raw_id: int) -> str:
    """Name for a raw COCO-stuff id (reference util/coco.py id2label).

    Raw id 182 maps to "unlabeled" (index 0); any other raw id ``k`` maps to
    table index ``k + 1``.  Out-of-range ids return "unknown" like the
    reference's fallthrough.
    """
    idx = 0 if raw_id == 182 else raw_id + 1
    if 0 <= idx < len(COCO_STUFF_NAMES):
        return COCO_STUFF_NAMES[idx]
    return "unknown"
