"""Set-up, window, trace, check and result line of one run."""
