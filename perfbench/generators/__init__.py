"""The general generators the traffic mixes name (``"generator"``): each turns
a configuration and a mix's parameters into set-up, a measured window and
the readings of its checks."""
