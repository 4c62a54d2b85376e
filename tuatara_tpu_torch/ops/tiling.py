"""Tiled detection for pages larger than the canvas.

Port of `tuatara_tpu/ops/tiling.py`. The reference downscales every page
so its long side fits the canvas (tuatara.cpp:352-358), which loses small
text on large pages. Tiled mode keeps the page at magnification
resolution, runs CRAFT over overlapping canvas-sized tiles (a page's tiles
are one batch) and max-blends the tile heatmaps back into one score map;
post-processing is unchanged. Overlap absorbs the convolutions' border
effects: every point of the page lies inside some tile away from its edge,
and the max prefers that view.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def tile_positions(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets covering [0, size) with tiles of `tile`, last clamped."""
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return pos


def extract_tiles(image: torch.Tensor, tile: int, overlap: int, ratio_net: int = 2
                  ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """[H, W, C] -> ([n_tiles, tile, tile, C], [(y, x)] tile origins).

    H and W must already be padded to >= tile. The stride (tile - overlap)
    must be a multiple of `ratio_net`: heatmaps are placed at (y // ratio_net,
    x // ratio_net), so another stride would misplace them by a fraction of
    a heatmap pixel."""
    h, w = image.shape[:2]
    stride = tile - overlap
    if stride % ratio_net:
        raise ValueError(
            f"tile stride {stride} (tile {tile} - overlap {overlap}) must be "
            f"a multiple of ratio_net={ratio_net} for exact heatmap stitching")
    coords = [(y, x) for y in tile_positions(h, tile, stride)
              for x in tile_positions(w, tile, stride)]
    tiles = torch.stack([image[y:y + tile, x:x + tile] for (y, x) in coords])
    return tiles, coords


def stitch_heatmaps(tile_scores: torch.Tensor, coords: List[Tuple[int, int]], out_h: int,
                    out_w: int, ratio_net: int = 2) -> torch.Tensor:
    """Max-blend tile heatmaps [n, t/r, t/r, C] into [out_h, out_w, C]
    (-inf where no tile lands), in tile order; origins are image
    coordinates, heatmaps are at 1/ratio_net resolution."""
    n, th, tw, c = tile_scores.shape
    out = torch.full((out_h, out_w, c), float("-inf"), dtype=tile_scores.dtype,
                     device=tile_scores.device)
    for i, (y, x) in enumerate(coords):
        y2, x2 = y // ratio_net, x // ratio_net
        view = out[y2:y2 + th, x2:x2 + tw]
        torch.maximum(view, tile_scores[i], out=view)
    return out
