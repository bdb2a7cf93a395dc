"""Errors shared by every layer of the port."""


def unported(what: str, slice_name: str = "3b") -> NotImplementedError:
    """The error for a knob of the JAX package that the port lacks yet."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with slice {slice_name} of the "
        f"port (ROADMAP.md, 'Slices of the port')")
