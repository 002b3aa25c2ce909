"""The fleet layer on the port: one front door for several spgemmd daemons
(the port's copy of the JAX package's `fleet/`).

  router.py      -- spgemm-router (`cli route`): polls every backend's
                    stats, places submits by the replicated price book,
                    caps a tenant's jobs across the fleet, proxies status
                    and wait to the job's backend, aggregates the scrape,
                    and re-submits a job once when its backend dies.
  pricebook.py   -- the router's merged book of (folder signature -> pair
                    mass), fed by each backend's `placement.book` gossip.
  fleet_smoke.py -- end-to-end proof: two daemons (on the card by default,
                    `--device cpu` on request) behind one router.

The router and the price book import neither torch nor numpy: the daemons
own the card, the router owns only sockets.
"""
