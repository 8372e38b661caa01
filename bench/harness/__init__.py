"""The cell runner: deployment, window, trace, roofline and comparison."""
