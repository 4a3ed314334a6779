"""The yardstick's arithmetic: FLOPs, bytes and the card's peaks."""
