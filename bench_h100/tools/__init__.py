"""One-off tools of the benchmark, run on the card by hand: the frozen work
counts (``count_work``) and the readings behind the limits
(``readings``). The benchmark's own runs never run them."""
