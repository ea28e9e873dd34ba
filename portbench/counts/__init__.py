"""The yardstick of the kernels' rooflines: operations and bytes from the
shapes, and the published peaks of the card."""
