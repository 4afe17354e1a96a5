"""100 × (1 − device busy ÷ wall) over the traced stretch of the cell's
units; busy is the union of the device's kernel, copy and set intervals."""

from portbench.roofline import idle_pct as read  # noqa: F401
