"""Development tools of the port that need no GPU."""
