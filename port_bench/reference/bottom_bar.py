"""The crop the window scan must find in a capture whose status bar sits
below the play area, worked out from the layout alone.  Imports nothing
of the program.

The reference's window rules (aws.hpp) accept the first changed contour
they discover, row by row from the top: with the bar at the bottom that
is the play area, ``border`` pixels in from each side and above the
bar's ``bar_rows`` rows and the border over it.  The crop keeps the
contour's rows and columns less one at the top left and two at the
bottom right (``maps.expected_crop``'s rule for a bar at the top).
"""

from __future__ import annotations

from typing import Tuple


def expected_crop(h: int, w: int, bar_rows: int, border: int
                  ) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) of the crop."""
    return border + 1, border + 1, w - border - 2, h - bar_rows - border - 2
