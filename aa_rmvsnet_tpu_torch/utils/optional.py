"""Optional host packages, imported where they are used.

The port's core needs torch and numpy alone.  The host tools need more:
tensorstore (orbax checkpoints), scikit-learn, scipy and matplotlib
(``cli analyze``, the previews of ``cli eval --save_png``), cv2 (images).
:func:`require` imports one on use and refuses by name where it is
missing, so that the package imports without them and the card's machine,
which lacks most of them, fails with a reason.
"""

from __future__ import annotations

import importlib


class MissingPackage(ImportError):
    """An optional package that the asked-for feature needs is not
    installed."""


def require(module: str, purpose: str):
    """``import module``, or :class:`MissingPackage` naming it and
    ``purpose`` (what needs it)."""
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise MissingPackage(
            f"{purpose} needs the {module.split('.')[0]} package, which is not "
            f"installed here ({exc})") from None


def pyplot(purpose: str):
    """matplotlib's ``pyplot`` on the non-interactive Agg backend."""
    matplotlib = require("matplotlib", purpose)
    matplotlib.use("Agg")
    return require("matplotlib.pyplot", purpose)
