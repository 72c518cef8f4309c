"""ADE20K SceneParse150 metadata (public MIT Scene Parsing benchmark
tables; role of the reference's detectron2 catalog registries,
register_ade20k_panoptic.py:8-165 / register_ade20k_full.py), the port's
own copy of the JAX package's data/ade_metadata.py (numpy only).

Each row is packed "T|S:rrggbb:name" (T = thing/instance class, S = stuff);
accessors unpack to names, a [150,3] uint8 palette, and thing/stuff id sets
for ``infer_segmentation`` overlays and panoptic post-processing."""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

_ROWS: Tuple[str, ...] = (
    "S:787878:wall",
    "S:b47878:building",
    "S:06e6e6:sky",
    "S:503232:floor",
    "S:04c803:tree",
    "S:787850:ceiling",
    "S:8c8c8c:road, route",
    "T:cc05ff:bed",
    "T:e6e6e6:window",
    "S:04fa07:grass",
    "T:e005ff:cabinet",
    "S:ebff07:sidewalk, pavement",
    "T:96053d:person",
    "S:787846:earth, ground",
    "T:08ff33:door",
    "T:ff0652:table",
    "S:8fff8c:mountain, mount",
    "S:ccff04:plant",
    "T:ff3307:curtain",
    "T:cc4603:chair",
    "T:0066c8:car",
    "S:3de6fa:water",
    "T:ff0633:painting, picture",
    "T:0b66ff:sofa",
    "T:ff0747:shelf",
    "S:ff09e0:house",
    "S:0907e6:sea",
    "T:dcdcdc:mirror",
    "S:ff095c:rug",
    "S:7009ff:field",
    "T:08ffd6:armchair",
    "T:07ffe0:seat",
    "T:ffb806:fence",
    "T:0aff47:desk",
    "S:ff290a:rock, stone",
    "T:07ffff:wardrobe, closet, press",
    "T:e0ff08:lamp",
    "T:6608ff:tub",
    "T:ff3d06:rail",
    "T:ffc207:cushion",
    "S:ff7a08:base, pedestal, stand",
    "T:00ff14:box",
    "T:ff0829:column, pillar",
    "T:ff0599:signboard, sign",
    "T:0633ff:chest of drawers, chest, bureau, dresser",
    "T:eb0cff:counter",
    "S:a09614:sand",
    "T:00a3ff:sink",
    "S:8c8c8c:skyscraper",
    "T:fa0a0f:fireplace",
    "T:14ff00:refrigerator, icebox",
    "S:1fff00:grandstand, covered stand",
    "S:ff1f00:path",
    "T:ffe000:stairs",
    "S:99ff00:runway",
    "T:0000ff:case, display case, showcase, vitrine",
    "T:ff4700:pool table, billiard table, snooker table",
    "T:00ebff:pillow",
    "T:00adff:screen door, screen",
    "S:1f00ff:stairway, staircase",
    "S:0bc8c8:river",
    "S:ff5200:bridge, span",
    "T:00fff5:bookcase",
    "S:003dff:blind, screen",
    "T:00ff70:coffee table",
    "T:00ff85:toilet, can, commode, crapper, pot, potty, stool, throne",
    "T:ff0000:flower",
    "T:ffa300:book",
    "S:ff6600:hill",
    "T:c2ff00:bench",
    "T:008fff:countertop",
    "T:33ff00:stove",
    "T:0052ff:palm, palm tree",
    "T:00ff29:kitchen island",
    "T:00ffad:computer",
    "T:0a00ff:swivel chair",
    "T:adff00:boat",
    "S:00ff99:bar",
    "T:ff5c00:arcade machine",
    "S:ff00ff:hovel, hut, hutch, shack, shanty",
    "T:ff00f5:bus",
    "T:ff0066:towel",
    "T:ffad00:light",
    "T:ff0014:truck",
    "S:ffb8b8:tower",
    "T:001fff:chandelier",
    "T:00ff3d:awning, sunshade, sunblind",
    "T:0047ff:street lamp",
    "T:ff00cc:booth",
    "T:00ffc2:tv",
    "T:00ff52:plane",
    "S:000aff:dirt track",
    "T:0070ff:clothes",
    "T:3300ff:pole",
    "S:00c2ff:land, ground, soil",
    "T:007aff:bannister, banister, balustrade, balusters, handrail",
    "S:00ffa3:escalator, moving staircase, moving stairway",
    "T:ff9900:ottoman, pouf, pouffe, puff, hassock",
    "T:00ff0a:bottle",
    "S:ff7000:buffet, counter, sideboard",
    "S:8fff00:poster, posting, placard, notice, bill, card",
    "S:5200ff:stage",
    "T:a3ff00:van",
    "T:ffeb00:ship",
    "T:08b8aa:fountain",
    "S:8500ff:conveyer belt, conveyor belt, conveyer, conveyor, transporter",
    "S:00ff5c:canopy",
    "T:b800ff:washer, automatic washer, washing machine",
    "T:ff001f:plaything, toy",
    "S:00b8ff:pool",
    "T:00d6ff:stool",
    "T:ff0070:barrel, cask",
    "T:5cff00:basket, handbasket",
    "S:00e0ff:falls",
    "S:70e0ff:tent",
    "T:46b8a0:bag",
    "T:a300ff:minibike, motorbike",
    "S:9900ff:cradle",
    "T:47ff00:oven",
    "T:ff00a3:ball",
    "T:ffcc00:food, solid food",
    "T:ff008f:step, stair",
    "S:00ffeb:tank, storage tank",
    "T:85ff00:trade name",
    "T:ff00eb:microwave",
    "T:f500ff:pot",
    "T:ff007a:animal",
    "T:fff500:bicycle",
    "S:0abed4:lake",
    "T:d6ff00:dishwasher",
    "T:00ccff:screen",
    "S:1400ff:blanket, cover",
    "T:ffff00:sculpture",
    "T:0099ff:hood, exhaust hood",
    "T:0029ff:sconce",
    "T:00ffcc:vase",
    "T:2900ff:traffic light",
    "T:29ff00:tray",
    "T:ad00ff:trash can",
    "T:00f5ff:fan",
    "S:4700ff:pier",
    "S:7a00ff:crt screen",
    "T:00ffb8:plate",
    "T:005cff:monitor",
    "T:b8ff00:bulletin board",
    "S:0085ff:shower",
    "T:ffd600:radiator",
    "T:19c2c2:glass, drinking glass",
    "T:66ff00:clock",
    "T:5c00ff:flag",
)


def class_names() -> List[str]:
    return [r.split(":", 2)[2] for r in _ROWS]


@lru_cache(maxsize=None)
def palette() -> np.ndarray:
    """[150, 3] uint8 — the standard ADE20K color per class id."""
    out = np.zeros((len(_ROWS), 3), np.uint8)
    for i, r in enumerate(_ROWS):
        h = r.split(":", 2)[1]
        out[i] = (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16))
    return out


def thing_ids() -> List[int]:
    return [i for i, r in enumerate(_ROWS) if r[0] == "T"]


def stuff_ids() -> List[int]:
    return [i for i, r in enumerate(_ROWS) if r[0] == "S"]


def metadata() -> Dict[str, object]:
    """Catalog-style dict (stuff_classes / stuff_colors / thing ids) matching
    what MetadataCatalog.set(...) records in the reference registries."""
    return {
        "stuff_classes": class_names(),
        "stuff_colors": [tuple(int(v) for v in c) for c in palette()],
        "thing_dataset_id_to_contiguous_id": {i: i for i in thing_ids()},
        "num_classes": len(_ROWS),
    }
