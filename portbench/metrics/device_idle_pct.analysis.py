"""100 × (1 − device busy ÷ wall) over the traced stretch of the cell's
units; busy is the union of a card's kernel, copy and set intervals,
averaged over the cell's cards."""

from portbench.roofline import idle_pct as read  # noqa: F401
