"""Chip smoke test of the PyTorch/CUDA engine (spark_rapids_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each:

1. build: nvcc builds every kernel of csrc/ for sm_90a, and g++ the
   shuffle's frame packer (csrc/kudo.cpp), in parallel, into
   build/torch_kernels/ (listed in .gitignore); prints the build seconds
   and each kernel's register use, and loads the packer.
2. setup: bench.py's lineitem (30M rows, seed 42, ~TPC-H SF5), its
   pyarrow answers, and the same table written as a Parquet file in a
   temporary directory with bench.py's writer settings (row groups of
   2^20 rows, so 29 of them; dictionary only for l_shipdate, l_quantity,
   l_returnflag and l_linestatus; snappy; data page v1).
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (murmur3 on int32[2^25] with edge values; segsum
   on the q72shfl chunk: N = 2^23 sorted ids over ~100,000 groups, 10 bf16
   lane planes, outcap = 2^18, some dead rows at id outcap, and on four
   more run shapes of 2^23 rows, from ~3,300-row groups to one group and
   to one row a group, on a line of their own; bitslice on
   random fields of 1-32 bits, and on l_shipdate's 12-bit dictionary codes
   of the file's first 2^20-row row group). Equality must be exact. `ms`
   is the median of CUDA-event timed calls, the host's launch overhead
   included; `kernel_ms` is the kernel's own device time per call, from
   torch.profiler.
4. path: the lineitem cached on the card with TorchSession, then four
   queries (q6, q1, q72shfl, and repartition(8, l_shipdate) + group-by),
   each checked against pyarrow on the host with bench.py's tolerances;
   q72shfl's 100,000 groups are also checked one by one. The kernels'
   launch counts are set to 0 before the path and read after; murmur3 and
   segsum must have run, and q72shfl must have taken the chunked segsum
   route.
5. parquet: read_parquet over the file, decoded on the card (the default)
   or on the host, then pq_q6 (q6 over its four columns, 2 x 29 bitslice
   launches per run), pq_q6_host (decode on the host, no bitslice
   launch), pq_q1_mixed (q1 over its six columns; the two string columns
   fall back to host decode) and pq_repart_agg (murmur3, bitslice, then
   the chunked segsum route), each run cold then warm and checked against
   the same pyarrow answers, group by group where there are groups. The
   launch counts are set to 0 before this path and read after; all three
   kernels must have run.
6. decode: every column of all 29 row groups decoded on the card equals
   pyarrow's decode of the row group exactly (compared on the card), and
   so does a matrix of generated files (mixed kinds with sparse and all
   nulls, delta, RLE booleans, date and timestamp) of 2^20 rows each.
7. strings: lineitem_text (30M rows: l_orderkey, l_returnflag,
   l_linestatus, l_quantity and l_comment, 10-43 characters per row cut
   from a 16 MB pool of TPC-H grammar words in random order, nearly all
   distinct, so a flat column of about 0.8 GB in a 2^30-byte plane)
   cached on the card, then str_case_agg
   (contains(upper(l_comment)) filter, group by the flags, count and
   sum(length(lower(l_comment))): the tiny-bucket route), str_group_flat
   (group by substring(upper(l_comment), 1, 9): the sort route) and
   str_prefix_rows (startswith(lower(l_comment)) and l_quantity < 3, then
   l_orderkey, concat of the flags, substring(upper(l_comment), 1, 12)),
   each cold then twice warm, checked against pyarrow's ASCII string
   functions (str_group_flat group by group, str_prefix_rows row by row).
   The launch counts are set to 0 before this path and read after; the
   case-map kernel must have run. The kernels phase also holds the
   case-map kernel against its plain version on the l_comment plane.
8. joins (run after the cached path, on the same lineitem and on
   bench.py's orders, 3M rows drawn after it from the same rng stream):
   lineitem and orders cached with 1 partition and again with 8, then
   q3join (bench.py's), q3join_shuffled (the same over the 8-partition
   caches with broadcastRowThreshold=0), q3_orderdate (grouped by
   l_orderkey and o_orderdate: the packed sort route), q3_revenue_by_date
   (the same join per order date: the chunked segsum route), q4_semi_anti
   (semi and anti joins against a 20M-row build with repeated keys, split
   three ways), q13_left (customers left join orders, then the
   distribution of order counts), flag_dim (a join on the two string flag
   columns with a 6-row dimension: the general pairs path), band_join
   (lineitem against 20 price bands on lo <= price < hi, no equi key: the
   nested-loop join), flag_cross (the flag dimension cross joined with a
   few lineitem rows: the cartesian product), sort_rows (all 30M rows of
   three columns ordered by a range exchange and eight sorts) and
   limit_rows, each cold then twice warm and checked against pyarrow or
   numpy. The 8-partition session sets both broadcastRowThreshold and
   spark.rapids.sql.adaptive.broadcastThresholdBytes to 0, so
   q3join_shuffled stays shuffled at run time too. Each query prints its
   operators and the probe path each join
   took; the operators and routes the queries are built to take are
   asserted, and the segsum kernel must have run.
8b. adaptive (right after the joins phase, on its caches, in sessions at
   the port's defaults): aqe_demote (q3join over the 8-partition caches
   with broadcastRowThreshold=0: planned shuffled, the filtered orders
   measure under 64 MB through their exchange and the join becomes a
   broadcast; warm runs reuse the build from the orders cache),
   aqe_stays_shuffled (orders join lineitem on the order key, the
   30M-row build: it stays shuffled and each side is partitioned once),
   aqe_row_probe (lineitem join a per-day count of orders on the ship
   date: a build of unknown size, 2,200 rows after the row probe,
   broadcast), aqe_skew (the 1-partition lineitem repartitioned 8 ways by
   a key 60% of the lines share, then grouped: the hot partition splits,
   and the decision equals skew_threshold of the per-partition counts
   from numpy's Spark murmur3), hash_exprs (hash(l_orderkey, l_quantity
   as int, l_shipdate) and xxhash64(l_orderkey, l_quantity,
   l_extendedprice) over all 30M rows, row by row against numpy's Spark
   hashes; B1 twice a run with per-row seeds; bench.py's lineitem has no
   l_linenumber, so the int cast of l_quantity is the second int
   column), and compact_repart / masked_repart (repart_agg with
   spark.rapids.shuffle.partitioning compact, then masked: the same
   answer and B1 launches). Each cold then twice warm, with its
   operators, decisions, exchanges, routes and launches.
9. window (on bench.py's first 10M rows, its q67win slice, cached with 1
   and with 8 partitions; every query ran over the 30M-row caches until
   the aggtypes phase joined the run): q67win (bench.py's),
   win_rank_family (the rank family over the flag pairs), win_running
   (running, bounded and lead/lag/first/last/nth frames over nearly 3M
   order-key partitions: the general route), win_shuffled (the
   8-partition cache: hash exchange with murmur3, packed window, segsum
   aggregate), win_global_top (a
   window without partition keys: the collect exchange) and dedupe_orders
   (drop_duplicates), each cold then twice warm and checked against numpy
   (sorts, boundary flags and running maxima). Each query prints its
   operators and window route; the routes the JAX package takes on the
   same caches are asserted, and murmur3 and segsum must have run in
   win_shuffled.
10. exprs (after the sql phase, on the joins phase's caches): q14_case
   (Q14's CASE inside SUM by ship date: the chunked segsum route),
   q1_stats (moments, first/last, abs: the tiny-bucket route),
   stats_by_order (moments per 17-bit order-key bucket: the scatter
   route), pctl_shuffled (percentiles and min_by/max_by over the
   8-partition cache: a hash exchange of raw rows) and cleanse_rows (a
   row query of CASE, integral division, nullif/nvl, greatest/least, the
   date and timestamp casts and the partition ids), each cold then twice
   warm and checked against numpy, with each run's aggregate routes and
   launch counts asserted exactly.
11. sets (after the exprs phase, on the joins phase's caches): q1_rollup
   (q1's filter under ROLLUP of the flags: one batch per grouping set),
   rollup_shipdate (ROLLUP of ship year and week over the numeric
   columns: one stacked batch of 3 x capacity, the chunked segsum
   route), cube_flags (CUBE of the flags with the grouping() markers),
   union_repart (the 8-partition cache's early lines with the quantity
   cast to int UNION ALL the 1-partition cache's late lines, widened,
   hash-repartitioned by ship date: murmur3 on every union batch, then
   the chunked segsum route), orders_setops (INTERSECT and EXCEPT over
   the 8-partition orders), range_agg (session.range of 2^28 ids over 8
   partitions, summed per id % 100003: partial per partition -> collect
   -> final, the JAX package's plan above 64M rows), pivot_flags (PIVOT of the return
   flag with the values inferred), describe_li (describe of three
   numeric columns and a correlation) and sample_li (a 1% sample by
   rand), each cold then twice warm and checked against numpy (range_agg
   against its closed form, sample_li against numpy's splitmix64
   stream), with each run's aggregate routes, Expand form and launch
   counts asserted exactly.
12. fallback (after the strings phase): one operator on the CPU, the
   rest on the card. fb_strmax over the strings phase's cached
   lineitem_text (a filter to quantity 1 on the card; upper(l_comment),
   folded into the aggregate by column pruning, its min/max and a count
   per flag pair on the CPU) and
   fb_moving_min over the joins phase's cached lineitem (repart_agg's
   daily sums on the card, B1 and B2; their 7-row moving minimum on the
   CPU; the ratio to it on the card), each cold then twice warm and
   checked against pyarrow or numpy. Each prints its placement report's
   CPU node, the fallback's download, CPU and upload ms and rows in and
   out, and its routes and launches; the one CPU node and its reason, the
   launches and the output batches on cuda are asserted.
13. aggtypes (after the sets phase, on the joins phase's lineitem caches
   and the decimal lineitem, l_quantity, l_extendedprice and l_discount
   as decimal(15,2), cached with 1 and 8 partitions): q72shfl_x3
   (q72shfl over the cached lineitem three times, UNION ALL: estimated at
   90M rows, so partial per partition -> collect -> final, the partials
   on the chunked segsum route), q1_dec and q6_dec (decimal sums exact,
   averages and FLOAT64 products to 1e-6), disc_groups (grouped by the
   decimal l_discount over 8 partitions) and order_lines (per order,
   collect_list of the ship dates and collect_set of the return flags
   over 8 partitions: a hash exchange of raw rows with murmur3, 3M array
   rows), each cold then twice warm and checked against numpy group by
   group, with each aggregate's mode, the exchanges, the routes and the
   launches (B2 x 12 in q72shfl_x3, B1 x 8 in order_lines) asserted
   exactly.
14. sql (after the window phase, on the joins phase's lineitem and
   orders caches and the window phase's 10M-row slice, registered as temp
   views, and on the Parquet file with orders written beside it):
   sql_q6, sql_q1, sql_q72shfl, sql_q3join and sql_q67win (the DataFrame
   queries of those names as SQL strings), sql_in_exists (IN (SELECT ...)
   and NOT EXISTS, lowered to left semi and anti joins, over the
   8-partition caches: shuffled, B1), sql_scalar_sub (an uncorrelated
   scalar subquery, run while the query is parsed), sql_rollup_cte (WITH,
   GROUP BY ROLLUP of the flags, UNION ALL), sql_math (round, floor, sqrt
   and pmod summed per return flag), and catalyst_q6 and catalyst_q3
   (tests/golden_plans/q6_filter_agg.json and q3_join_agg_topn.json made
   to read bench.py's columns, through plan/catalyst.py: B3 decodes the
   scans), each held to the earlier paths' answers or to numpy's. Each
   prints its parse time (session.sql or ingest_catalyst), cold and warm
   times, peak memory, operators, routes and launches, and whether they
   equal those of the DataFrame query of the same name (run once before
   it), with the DataFrame query's beside them where they do not.
15. datetime (after the aggtypes phase): lineitem_dt, the lineitem with
   l_shipdate as DATE, l_commit_ts as TIMESTAMP (the ship day plus a
   seeded time of day), l_shipdate_str ('yyyy-MM-dd' strings), cached
   with 1 and 8 partitions (it prints where each zone's TZif file was
   found; a zone that cannot be found fails the run): dt_year_month
   (revenue per year and month), dt_q6_add_months (Q6 with
   add_months(date '1994-01-01', 12)), dt_daily_repart (the 8-partition
   cache repartitioned by cast(l_commit_ts as date), revenue per day with
   its dayofweek: B1 x 8, B2 x 4), dt_ts_parts (lines per hour, dayofweek
   and quarter: B2 x 4; then a row query of the other timestamp and date
   functions over the 1.2M lines with l_quantity < 3), dt_tz_session (a
   session in America/New_York: counts per local year, month and hour
   and per local day, and from_utc_timestamp/to_utc_timestamp summed per
   local hour, against offsets from Python's zoneinfo reading the same
   TZif files), dt_cast_strings (string -> date over the dictionary and
   over rendered flat strings, the order key's decimal round trip, the
   years parsed as doubles, and lines per rendered hour), dt_format_fb
   (date_format over the l_quantity = 1 lines: the one CPU node) and
   sql_dt (dt_year_month's grouping as SQL with quarter and a
   cast('1995-01-01' as date) filter), each cold then twice warm and
   checked against numpy and python's calendar, with routes, CPU nodes
   and launches asserted exactly.
16. regex (right after the strings phase, on its cached lineitem_text):
   rx_rlike_flags (rlike(l_comment, 'b(l|r)[a-z]+ly') per flag pair:
   count and octet_length sum), rx_like_nfa (lines per outcome of LIKE
   '_u%' and '%ar_', the device NFA, and '%ly', an endswith),
   rx_extract_groups (lines per regexp_extract(l_comment, '([a-z]+)ly ',
   1): the sort route), rx_replace (the characters of regexp_replace(
   l_comment, '[aeiou]+', '*') per flag pair, then the replaced comments
   of the l_quantity < 3 lines), rx_breadth_rows (trim ... chr, crc32
   and hive_hash over those ~1.2M lines; B4 in upper(trim(...))),
   rx_cpu_rows_fb (the CPU row functions over the l_quantity = 1 lines
   whose order key is a multiple of 60: one CPU Project), rx_q13_fb
   (Q13's NOT LIKE '%quick%sleep%' over the l_quantity = 1 lines: a CPU
   Filter, as in the JAX package) and sql_regex (the LIKE and RLIKE
   filters and the extraction as SQL, with initcap and trim), each cold
   then once warm and checked against pyarrow's RE2 and ASCII kernels,
   zlib, a numpy Hive hash, hashlib, base64 and Python's re, with routes,
   CPU nodes and launches asserted exactly.
17. nested (after the datetime phase, on the joins phase's lineitem and
   orders): orders_nested, one row per order (3M: o_orderkey,
   o_custkey, o_info a struct of the order date and customer, the
   order's lines as three aligned arrays l_qty, l_price and l_ship, 30M
   elements each, l_price null for every 97th order, and o_flag_qty, a
   map from each flag pair to its summed quantity), built on the host
   and cached with 1 and 8 partitions: nx_explode_daily (the prices
   exploded beside o_info.orderdate over the 8-partition cache, hash-
   repartitioned by the date and summed per day: B1 x 8, then the chunked
   segsum route, B2 x 4), nx_posexplode_outer (grouped by position, a
   null row per null or empty array), nx_array_rows (size, element_at,
   [], array_contains, array_min/max, sort_array, slice, array_distinct,
   array_position, array_remove, arrays_overlap and the set operations
   over ~30,000 orders, row by row), nx_struct_map (the struct's fields
   and the map's keys, values, lookups and size row by row, then the map
   exploded per flag pair), nx_stack (stack(2, ...) over the cached
   lineitem: the Expand per projection, the sort route), nx_cpu_
   collections_fb (the host-tier functions and map_entries over ~10,000
   orders: one CPU Project), nx_sibling_fb (an explode carrying another
   array: the CPU Generate), sql_nested (the daily explode as SQL over a
   temp view) and ingest_generate (a plan document's Parquet scan and
   generate: the CPU Generate, B3 and B2), each cold then once warm and
   checked against numpy on the lineitem itself and Python rows, with
   routes, CPU nodes, Expand forms and launches asserted exactly.
17b. shuffle (right after the formats phase, on the joins phase's
   8-partition caches h8, bench.py's lineitem and orders, every query in
   test mode): sh_q72shfl (q72shfl's grouping behind a hash exchange of
   its int key: B1, then B2), sh_repart_agg and sh_q3join_shuffled, each
   cold then twice warm under spark.rapids.shuffle.mode=MULTITHREADED and
   then SERIALIZED at the JAX package's defaults (codec auto, a 256 MiB
   host budget, 8 writer and 8 reader threads): the same answer, the
   same B1 and B2 launches a run, bytes written and spilled, both warm
   times; sh_disk (sh_repart_agg under a 64 MiB host budget: blobs on
   disk, the answer exact), sh_corrupt (one corrupt shuffle.read: one
   re-fetch, shuffleCorruptionRetries 1, the answer exact), sh_xproc (a
   subprocess of the port, which must import no JAX, writes the exchange
   files of the first 5M lines keyed on l_orderkey, n_out 8; this
   process mounts them, aggregates them exactly and checks every key's
   reduce partition against numpy's Spark murmur3), wr_parquet_q1 (the
   first 5M lines written by DataFrame.write partitioned by the flags,
   read back through the device-decode source, B3, and q1 checked) and
   tb_delta_merge (the orders as a Delta table, 300,000 upserts merged
   in, checked against numpy's upsert; an Iceberg table in two appends
   with a snapshot read; a Hive text round trip of 250,000 lines).
17c. udf (right after the shuffle phase, on the joins phase's caches):
   udf_q72_compiled (q72shfl's grouping of udf(charge) = price x (1 -
   discount) x (1 + a tax from the order key), compiled with
   spark.rapids.sql.udfCompiler.enabled: no CPU node, the chunked segsum
   route, B2), udf_repart_torch (a torch_udf with its own validity over
   the 8-partition cache, then a hash exchange of an int key and the
   grouping: B1 and B2, exact against numpy), udf_row_pool (an opaque row
   UDF, a string method call, in a CPU Project over the first 500,000
   lines,
   with the Python worker pool off and on: the workers used and the CPU
   step's ms, both equal to a Python loop) and udf_compiled_vs_row (one
   lambda compiled and on the row tier: equal answers), each cold then
   warm; the pool is shut down at the end.
17d. trace (after the fallback phase): q1 on the 1-partition cache,
   q3join_shuffled on the 8-partition caches, pq_q6 (B3) and the paged
   q1 of rt_paged_q1, each run with tracing off and then on
   (spark.rapids.sql.trace.enabled, into the temporary directory): the
   same answers and launches, the warm ms of both beside the earlier
   phases' for the same query, the artifacts parsed as Chrome trace JSON
   by tools/profiler_report.py, each exec's span total within 1% of its
   last_metrics() timer, and the semaphore and spill instants in the
   paged query; then one traced q3join_shuffled under torch.profiler,
   whose ranges must hold every exec span's name.
17f. obs (after the trace phase): the live layer (spark.rapids.obs.*) is
   on by default, so every other phase runs through it. Here q1 (the
   1-partition cache), q3join_shuffled (the 8-partition caches),
   pq_repart_agg (the Parquet file: B1, B3, B2) and q1_rollup (~2 s on
   the card) each run warm with the layer off (obs, flight recorder and
   sampler; the process-wide layer is torn down first), at its defaults
   (q1 and q3join_shuffled only: "quiet") and at its defaults with the
   endpoint on a free port scraped at /queries and /metrics every 50 ms
   by a thread of this process ("on"): q1 and q3join_shuffled three runs
   a mode in two rounds, pq_repart_agg and q1_rollup one in one round,
   then the off and on modes' last run under torch.profiler's
   CUDA activity. Checked: every answer right and bitwise equal across
   the modes (q1_rollup's float sums, whose atomics add in another order
   in every run, off against off too, to 1e-12 relative), the same
   launches, the same cudaMemcpy* calls (every direction),
   cuda*Synchronize calls and device-to-host copies on the card off and
   on (torch.profiler can drop the card's copy records of a run while it
   keeps the host's calls: a profiled run whose trace lacks the record of
   some copy call is run again, up to three runs in all, the counts are
   the run's that dropped the fewest, and the device-to-host copies off
   and on must agree within the calls whose record was dropped, exactly
   where none was), rapids_queries_total{status="ok"} one a run
   and the same tasks a run, scan progress never going down (above 0 in
   pq_repart_agg; a cache scan counts no rows, in both packages), the
   sampler's device_bytes_held above 0 during q1. q1_rollup's timed on
   run also scrapes /healthz: it must show the query executing and the
   probe alive (its side stream does not queue behind the query) under
   probeTimeoutMs. Printed per query: warm ms per mode (best and
   median) and their ratios to off, device ms and idle share, copies
   and syncs, the probe's ms, sampler ticks. Then a device.dispatch
   fault's flight dump (a Chrome trace with the query's queryStart
   marker and id) and an SLO breach's (a tiny slo.latencySeconds after
   slo.minRuns runs).
17g. history (after the obs phase, on its caches and Parquet file, at
   the defaults and in test mode): q1, q3join_shuffled, pq_repart_agg and
   pctl_shuffled (8 partitions: its exchange launches B1) each run with
   the live layer off and the attribution fold patched out ("plain",
   warm only: the caches are warm), at the defaults ("default") and with
   spark.rapids.obs.historyDir set ("history"), these two once cold and
   once warm, every warm run under torch.profiler's CUDA activity. Checked: every answer right and
   equal across the modes, the same launches; every top-level action's
   wall-time attribution whose buckets sum to its wall within 1%, and
   rapids_query_seconds_bucket summing to the default runs' walls; the
   default runs' copy calls, cuda*Synchronize calls and device-to-host
   copies equal to the plain runs' (the attribution reads no device
   value); every history record ok, with its query's plan digest, an
   annotated plan, buckets summing to its wall, and row counts equal to
   last_metrics() after the run. Then a copy of pctl_shuffled's record
   with a dispatch-bound shuffle verdict is appended and the query runs
   again: its ShuffleExchangeExec must become a CollectExchangeExec,
   last_aqe() must hold the measured_cost decision and the answer must
   equal the uncollapsed one sorted by key (and numpy's). Last, q1's
   explain("analyze") (rows, batches, time, the attribution section)
   and to_device_batches() (CUDA tensors, the collect's rows, and at
   least one device-to-host copy per result column fewer than the
   collect: no column plane comes down). Printed per query: warm ms,
   device ms and idle share, copies and syncs per mode, what history on
   adds, the buckets in ms; the collapse's warm ms and B1 launches before
   and after.
17h. fusion (after the history phase, on the joins phase's 1-partition
   lineitem cache and the Parquet file): every phase runs with stage
   fusion on, its default; here the queries of
   torch_port_helpers.fusion_queries (q6, q1, pq_q6 with its device
   decode absorbed into the aggregate, q72shfl, q72shfl_repart (B1),
   rollup_shipdate (a fused stage with the Expand, B2) and limit_chain
   (Filter, Project and LIMIT 100 over the device decode, one fused
   stage with B3)) run with spark.rapids.sql.stageFusion.enabled off and
   on: cold, then twice warm in turns, then once each under
   torch.profiler's CUDA activity, then once on under its CPU and CUDA
   activity. Checked: answers equal off and on (bitwise; rollup_shipdate
   to 1e-6, its Expand changes form) and right against numpy/pyarrow;
   the fusion groups equal the JAX package's (FUSION_EXPECT) on and none
   off; stageDispatches equal the stages' input batches; B1-B3 launches
   equal off and on, but rollup_shipdate's B2: its Expand yields a batch
   a projection off and one stacked batch on, so on it must launch the
   sets phase's 12 (off 4, only the full grouping set's batch on the
   chunked segsum route); a stage range in the profiled run of every fused
   query; limit_chain stops before the end of its input, pulling no more
   batches on than off. Printed per query: fused and absorbed stages,
   fusion groups, narrow dispatches a batch, stageDispatches and input
   batches, warm ms, device ms and idle share, peak GB and launches off
   and on, and per stage range its batches, kernel launches a batch and
   host ms a batch.
17i. audit (after the fusion phase, on the joins phase's caches, with
   spark.rapids.obs.audit.enabled): two cold audited runs of the NDS
   probe's first two queries (tools/torch_gen_cost_signatures.py's
   recipe), q1_rollup and q3join_shuffled give equal cost signatures;
   the prefix's signature against the CPU golden
   (tests/torch_cost_signatures.json) and a CPU run of it (the aten ops
   whose charged bytes differ printed); repart_agg (B1, B2), pq_q6 over a
   small file (B3) and str_case_agg (B4) over 200,000 / 50,000 lines on
   the card and on the CPU: the hand kernels' charges must be equal; per
   query the roofline groups and achieved GB/s over the attribution's
   device_compute seconds and over torch.profiler's device ms; warm ms
   with the audit on over off; pctl_shuffled's real audited record
   driving the measured pass; warmup's replays from a history store and
   the first user query with and without them, both after
   compile_cache.clear(); a spark.rapids.profile.dir capture that parses
   and names a hand kernel; the compile counters against the build
   phase's builds and the libraries' loads; and the window and masked
   probe dispatches through exec/fuse.fused.
18. runtime (last, after the fallback phase, so that its small budgets,
   injected faults and open breaker touch no earlier phase; on the joins
   phase's lineitem caches h1 (1 partition) and h8 (8), the Parquet file
   and the first 5M lines; every other phase runs at the JAX package's
   defaults, a 12 GiB device budget and two device tasks at once, and
   prints its spill counters on a "spill" line): rt_paged_q1 (q1 over h8
   under a budget of half its bytes: partitions page device -> host ->
   device in every run), rt_disk_cascade (q6 over h8 with a host store
   below one partition: partitions go to the disk and come back),
   rt_split_q1 / rt_retry_q1 (q1 over h1 with one injected split, then
   three injected retry OOMs) and rt_split_q72shfl (B2 split against
   unsplit), rt_real_oom (a real torch.OutOfMemoryError in q1's update:
   the process's share of the card capped just above what it holds, a
   4 GiB spillable ballast that the retry's drain moves to the host),
   rt_wave_repart (repart_agg over h8: its exchange reads the 8 cache
   partitions one after another, each a task, at most 2 on the card, B1
   and B2), rt_wave_pctl (pctl_shuffled over h8: its aggregate runs once
   per exchange partition, so the collect's 8 partitions are one task
   wave with exactly 2 on the card; B1), rt_admission (four threads,
   spark.rapids.query.maxConcurrent=1: no two execution windows
   overlap), rt_quota (a query quota that the first 5M lines, cached in
   4 partitions, overflow: only that query's handles spill, while q6 over
   h1 runs beside it with its partition on the card throughout),
   rt_cancel_scan (pq_q1_mixed cancelled 0.5 s in, then under a 0.3 s
   deadline, then rerun to its answer with B3) and rt_degrade (with CPU
   fallback on: an injected scan fault degrades q6 three times, the
   breaker opens and the next query skips the card, the half-open probe
   runs q72shfl on the card with B2, an ANSI divide by zero fails). Each
   query is checked against the answers above and prints its warm ms,
   peak memory, launches, status, summed task accumulators and spill
   counters; after each, every semaphore permit is back, no cancel token
   is left and no spillable handle outlives the live caches.
17e. pipeline (right after the decode phase, on the files earlier phases
   wrote): spark.rapids.sql.pipeline.enabled is on by default, so every
   other phase's file and in-memory scans already run behind a
   PipelineExec (the producer's uploads on a side CUDA stream). Here
   pq_q6 (B3), pq_q6_host, pq_repart_agg (B1, B3, B2), fm_hive_q1 and
   fm_csv_q1 (the formats phase's hive layout and CSV) and sh_file_scan
   (sh_xproc's exchange files through ShuffleFileScan) each run warm with
   pipelining off, then on, both under torch.profiler's CUDA activity
   (kernels and copies with their streams; the host is not traced, so
   the warm ms carry no host tracing cost). Checked: on and off answers bitwise equal, each
   matching pyarrow at bench.py's tolerances (sh_file_scan exactly), the
   same launches, a PipelineExec at depth 2 over every scan of the
   pipelined plan and none in the synchronous one, and over the phase at
   least one host-to-device copy on a stream other than the consumer's
   kernels overlapping one of those kernels. Printed per query: warm ms
   on and off, pipelineStallTime and pipelineProducerTime, device busy ms
   and idle share and the copies on each stream of both runs, peak GB on
   and off, launches. Then a LIMIT 1000 over the pipelined
   device-decode scan (it stops early; no pool worker runs engine code
   after it) and a spark.rapids.debug.faults spec at pipeline.producer
   (the query fails with the injected error).
Depth cuts (to keep the script within its time with the pipeline
phase; with the fusion phase the cached path and the udf phase run
each query cold and once warm, not twice): the regex, nested and formats phases take one warm run after
the cold one instead of two; with the obs phase the joins, sql, sets,
aggtypes, datetime, fallback and shuffle phases do too (WARM_RUNS),
where the text above says twice warm; with the history phase the
adaptive, window and exprs phases do too, the trace phase runs each
query cold and once warm a mode (not twice warm), the obs phase runs q1
and q3join_shuffled in one round (not two), and rt_degrade runs over the
first 500,000 lines (not 1M); with the audit phase the formats phase
runs its six host-bound file queries cold only (FORMATS_COLD_ONLY), the
Hive text round trip takes 250,000 lines (not 1M) and the udf phase's
row tier 500,000 (not 1M).
Every query path runs in test mode (spark.rapids.sql.test.enabled): an
operator that planning tags off the card fails the query, except the one
node each fallback query names in spark.rapids.sql.test.allowedNonTpu.
It then prints the kernel table ({"kernels": [...]}, with each kernel's
launches per path in "launches_by_path": cached, parquet, pipeline,
strings, joins, adaptive, window, sql, exprs, sets, aggtypes, datetime,
nested, formats, shuffle, udf, regex, fallback, trace, obs, history,
fusion, audit, runtime),
the card's name and power limit, and as its last line {"ok": true,
"device": {...}}. Any failure exits non-zero without that line; so does a
machine without CUDA, and so does a run that imported the JAX package.
The lineitem generators and the string, join, window, expression, set,
aggregate-type, datetime, regex and nested query shapes are the ones of
tests/torch_port_helpers.py, which the CPU tests run too.
`python3 chip_smoke.py --phase shuffle` runs the build, the setup, the
8-partition caches and the shuffle phase alone.
`python3 chip_smoke.py --segsum-against OTHER.cu [...]` runs only the
segsum shapes, through the checkout's kernel and a build of each other
segsum source (the same C interface), each held exactly against the plain
version and timed by the profiler in turns (other, this, this, other).
CHIP_SMOKE_PROFILE=1 adds a torch.profiler pass over each query of the
query paths, with each port kernel's launches, device time and
bounds at the shapes the query gave it, and ranks the kernels by device
time above bound over those runs (CHIP_SMOKE_TRACE_DIR=dir also writes
the queries' Chrome traces).
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

ROWS = 30_000_000
LO, HI = 8766, 9131
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_NAMES = ("murmur3", "segsum", "bitslice", "case_map")
#: host C++ of csrc/ built beside the kernels: the shuffle's frame packer
HOST_LIBS = ("kudo",)
#: bench.py decode_pass's writer settings (bench.py:516-519)
#: warm runs after the cold one in the joins, sql, sets, aggtypes,
#: datetime, fallback and shuffle phases (depth cut: one where there were
#: two, to keep the whole script within its time with the obs phase)
WARM_RUNS = 1
RUNS = 1 + WARM_RUNS
#: warm runs of the cached path phase (cut from two to pay for the
#: fusion phase)
PATH_WARM_RUNS = 1
PARQUET_WRITE = dict(row_group_size=1 << 20,
                     use_dictionary=["l_shipdate", "l_quantity",
                                     "l_returnflag", "l_linestatus"],
                     compression="snappy", data_page_version="1.0")
Q6_COLS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q1_COLS = ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
           "l_extendedprice", "l_discount"]


#: guards the spies' counters: a query's partitions run as a task wave,
#: on several threads
SPY_LOCK = threading.Lock()
#: readings an earlier phase leaves for a later one (the runtime phase
#: prints the cached phase's unpaged q1 beside its paged one, and checks
#: pctl_shuffled against the exprs phase's answers)
RUN_NOTES = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def helpers():
    """tests/torch_port_helpers.py: the lineitem generators and the string
    query shapes, shared with the CPU tests (numpy and pyarrow at
    import)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import torch_port_helpers
    return torch_port_helpers


def device_session(conf=None, allowed: str = ""):
    """A session on the card in test mode: an operator tagged off the
    device fails the query, unless ``allowed`` (comma-separated plan node
    names) names it. Every query path runs in one."""
    from spark_rapids_tpu_torch import TorchSession
    return TorchSession({**(conf or {}),
                         "spark.rapids.sql.test.enabled": "true",
                         "spark.rapids.sql.test.allowedNonTpu": allowed})


def port_api():
    from types import SimpleNamespace

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr.window import Window
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql import udf as U
    return SimpleNamespace(col=E.col, lit=E.lit, F=F, E=E, T=T,
                           Window=Window, udf=U.udf, col_udf=U.torch_udf)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_ms(fn, match: str, reps: int = 20) -> float:
    """Device time per call of the CUDA kernels whose name contains
    ``match``, from torch.profiler over ``reps`` calls of fn: the kernel
    alone, without the host's launch overhead, which the event times of
    time_ms include when the kernel is shorter than it. The 50 MB L2 cache
    is overwritten before each call, so inputs that fit in it are read
    from device memory, as a first call would read them. The profiler can
    drop kernel records: the time is averaged over the launches it
    recorded, and a run that recorded fewer than ``reps`` is repeated, up
    to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total_us, calls = 0.0, 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if match in e.key]
        total_us = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in hits)
        calls = sum(e.count for e in hits)
        if calls >= reps:
            break
    if not calls:
        raise AssertionError(f"the profiler saw no kernel named *{match}*")
    return total_us / calls / 1e3


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from spark_rapids_tpu_torch.ops import _build
    from spark_rapids_tpu_torch.shuffle import serde
    t0 = time.perf_counter()
    logs = _build.build_all(list(KERNEL_NAMES) + list(HOST_LIBS))
    secs = time.perf_counter() - t0
    # the shuffle's frame packer is host C++: it must load, not fall back
    packer = serde.kudo_lib()._name
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "built": sorted(logs),
          "ptxas": {n: r for n, r in regs.items() if n not in HOST_LIBS},
          "packer": packer})
    return sorted(logs)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(pq_path: str, comment_plane):
    import torch
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []

    # B1 murmur3 on the cached batch's capacity (2^25 rows)
    n = 1 << 25
    x_np = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    x_np[:4] = [-2 ** 31, -1, 0, 2 ** 31 - 1]
    x = torch.from_numpy(x_np).to(dev)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n,
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev)
    got = MK.murmur3_int32(x, 42)
    want = MK.murmur3_int32_plain(x, 42)
    got_r = MK.murmur3_int32(x, seeds)
    want_r = MK.murmur3_int32_plain(x, seeds)
    # murmur3 takes any length and offset: the kernel masks the tail
    r_n = n - 5
    got_v = MK.murmur3_int32(x[3:r_n], seeds[3:r_n])
    want_v = MK.murmur3_int32_plain(x[3:r_n], seeds[3:r_n])
    torch.cuda.synchronize()

    def max_diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    err = max(max_diff(got, want), max_diff(got_r, want_r),
              max_diff(got_v, want_v))
    if err:
        raise AssertionError(f"murmur3 kernel differs from its plain "
                             f"version (max abs err {err})")
    ms = time_ms(lambda: MK.murmur3_int32(x, 42))
    kernel_ms = kernel_device_ms(lambda: MK.murmur3_int32(x, 42), "murmur3")
    plain_ms = time_ms(lambda: MK.murmur3_int32_plain(x, 42), reps=5)
    nbytes = n * 4 + n * 4
    rows.append({"name": "murmur3_int32", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
                 "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:97",
                 "shape": f"int32[{n}], scalar seed",
                 "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
                 "plain_ms": plain_ms,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": None})

    # B2 segsum: the q72shfl chunk shape is the kernels line's row; it and
    # four more run shapes go on a line of their own
    seg_rows = [segsum_shape_row(S.segsum, shape)
                for shape in segsum_shapes(rng, dev)]
    emit({"phase": "kernels.segsum_shapes", "shapes": seg_rows})
    q72 = seg_rows[0]
    rows.append({"name": "segsum", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/csrc/segsum.cu",
                 "replaces": "spark_rapids_tpu/ops/pallas_segsum.py:90",
                 **{k: q72[k] for k in ("shape", "max_abs_err", "ms",
                                        "kernel_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}})
    rows.append(bitslice_row(pq_path, rng, dev))
    rows.append(case_map_row(comment_plane, rng, dev))
    emit({"phase": "kernels", "results": rows})
    return rows


def segsum_shapes(rng, dev):
    """B2's shapes at 2^23 rows, one at a time: (label, gid, payload,
    outcap). First the q72shfl chunk (~100,000 groups of ~84 rows, 1 live
    count + 3 key digits + 6 float digits, dead rows at id outcap), drawn
    from rng; then, drawn on the card from a seed: (a) ~2,500 groups of
    ~3,300 rows with P = 11 and dead rows at id G (the date-keyed call
    sites), (b) 128 groups of 2^16 rows with P = 10 (the longest runs the
    route keeps), (c) one group over the whole chunk with 0/1 lanes
    (rollup_shipdate's fallback chunks) and (d) every row its own group
    with outcap 2^24. 8-bit digits where groups stay within 2^16 rows and
    0/1 lanes beyond, so every sum is an integer below 2^24 and the kernel
    must equal its plain version exactly."""
    import torch
    N = 1 << 23
    P, outcap, ngroups, dead = 10, 1 << 18, 100_000, 4096
    gid_np = np.sort(rng.integers(0, ngroups, N - dead)).astype(np.int32)
    gid_np = np.concatenate([gid_np, np.full(dead, outcap, np.int32)])
    lanes = np.zeros((P, N), np.float32)
    lanes[0, :N - dead] = 1.0                                   # live count
    lanes[1:4] = rng.integers(0, 256, (3, N))                   # key digits
    lanes[4:10] = rng.integers(-128, 129, (6, N))               # float digits
    yield ("q72shfl chunk: ~100,000 groups, P 10",
           torch.from_numpy(gid_np).to(dev),
           torch.from_numpy(lanes).to(dev).to(torch.bfloat16), outcap)
    del gid_np, lanes
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def digits(P, lo, hi):
        return torch.randint(lo, hi, (P, N), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.bfloat16)

    live = N - 4096
    gid = torch.full((N,), 2500, dtype=torch.int32, device=dev)
    gid[:live] = torch.sort(torch.randint(0, 2500, (live,), generator=gen,
                                          device=dev, dtype=torch.int32))[0]
    pay = digits(11, -128, 129)
    pay[0] = 1.0
    pay[:, live:] = 0.0
    yield "(a) ~2,500 groups of ~3,300 rows, P 11", gid, pay, 1 << 12
    gid = (torch.arange(N, device=dev, dtype=torch.int32) >> 16)
    yield ("(b) 128 groups of 2^16 rows, P 10", gid, digits(10, 0, 256),
           1 << 11)
    yield ("(c) one group of 2^23 rows, 0/1 lanes, P 11",
           torch.zeros(N, dtype=torch.int32, device=dev), digits(11, 0, 2),
           1 << 11)
    yield ("(d) every row its own group, outcap 2^24, P 10",
           torch.arange(N, device=dev, dtype=torch.int32),
           digits(10, -128, 129), 1 << 24)


def segsum_bound_ms(gid, payload, outcap) -> float:
    return launch_bytes("segsum", gid, payload, outcap) / HBM_BYTES_PER_S \
        * 1e3


def segsum_shape_row(kernel, shape):
    """One of segsum_shapes through ``kernel`` (the wrapper, or another
    build's launch): held exactly against segsum_plain, then timed beside
    the plain version and index_add_."""
    import torch
    from spark_rapids_tpu_torch.ops import segsum as S
    label, gid, pay, outcap = shape
    got = kernel(gid, pay, outcap)
    want = S.segsum_plain(gid, pay, outcap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"segsum kernel differs from its plain version "
                             f"at {label} (max abs err {err})")
    del got, want
    keep = (gid >= 0) & (gid < outcap)
    g64 = gid[keep].to(torch.int64)
    p32 = pay[:, keep].t().to(torch.float32).contiguous()
    P = pay.shape[0]
    row = {"shape": f"{label}: gid int32[{gid.numel()}], payload "
                    f"bf16[{P},{gid.numel()}], outcap {outcap}",
           "groups": int(torch.unique_consecutive(gid).numel()),
           "max_abs_err": err,
           "ms": time_ms(lambda: kernel(gid, pay, outcap)),
           "kernel_ms": kernel_device_ms(lambda: kernel(gid, pay, outcap),
                                         "segsum"),
           "plain_ms": time_ms(lambda: S.segsum_plain(gid, pay, outcap),
                               reps=10),
           "bound_ms": segsum_bound_ms(gid, pay, outcap),
           "bound_by": "bytes",
           "library_ms": time_ms(lambda: torch.zeros(
               outcap, P, device=gid.device).index_add_(0, g64, p32),
               reps=10)}
    return row


def _file_digest(path: str) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def segsum_library(path: str):
    """Another build of a segsum source (same C interface), as a function
    of (gid, payload, outcap) like the wrapper's."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_ROOT,
                           f"against-{_file_digest(path)}")
    lib_path = os.path.join(out_dir, "libsegsum.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            lib_path, path], capture_output=True, text=True)
        with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
            f.write(r.stdout + r.stderr)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.segsum_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.segsum_launch.restype = ctypes.c_int

    def run(gid, pay, outcap):
        out = torch.zeros(outcap, pay.shape[0], dtype=torch.float32,
                          device=gid.device)
        rc = lib.segsum_launch(gid.data_ptr(), pay.data_ptr(),
                               out.data_ptr(), gid.numel(), pay.shape[0],
                               outcap, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"segsum ({path})")
        return out
    return run


def compare_segsum(paths) -> int:
    """--segsum-against A.cu [B.cu ...]: the checkout's B2 and each other
    build of a segsum source at every shape of segsum_shapes, each held
    exactly against segsum_plain, then timed by the profiler in turns,
    forward and back (for one other source: other, this, this, other).
    One JSON line per shape; exits non-zero if any build disagrees."""
    import torch
    from spark_rapids_tpu_torch.ops import _build
    from spark_rapids_tpu_torch.ops import segsum as S
    card = nvidia_smi()
    print(card, flush=True)
    logs = _build.build_all(["segsum"])
    builds = [(p, segsum_library(p)) for p in paths] + [("checkout",
                                                          S.segsum)]
    ptxas = {}
    for p in paths:
        with open(os.path.join(_build.BUILD_ROOT, "against-"
                               + _file_digest(p), "nvcc.log")) as f:
            logs[p] = f.read()
    for name, log in logs.items():
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "segsum.builds", "ptxas": ptxas})
    order = builds + builds[::-1]
    for shape in segsum_shapes(np.random.default_rng(7), torch.device("cuda")):
        label, gid, pay, outcap = shape
        times = {p: [] for p, _ in builds}
        for p, fn in builds:
            got = fn(gid, pay, outcap)
            want = S.segsum_plain(gid, pay, outcap)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{p} differs from segsum_plain at "
                                     f"{label}")
            del got, want
        for p, fn in order:
            times[p].append(kernel_device_ms(
                lambda fn=fn: fn(gid, pay, outcap), "segsum"))
        emit({"phase": "segsum.compare", "shape": label,
              "bound_ms": segsum_bound_ms(gid, pay, outcap),
              "kernel_ms": times,
              "mean_kernel_ms": {p: statistics.mean(v)
                                 for p, v in times.items()}})
    print(card, flush=True)
    return 0


def comment_plane(text):
    """l_comment's byte plane on the card, as the cache uploads it."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import (
        _string_planes, round_capacity,
    )
    _, raw = _string_planes(text["l_comment"].combine_chunks())
    plane = torch.zeros(round_capacity(len(raw), minimum=8),
                        dtype=torch.uint8, device="cuda")
    plane[:len(raw)] = torch.from_numpy(raw).cuda()
    return plane


def case_map_row(plane, rng, dev):
    """B4 case map against its plain version, both directions, exactly:
    on the l_comment byte plane (padding included), on 2^30 random bytes
    0-255, on lengths 0, 1, 15, 17 and 4095, and on a view at an odd
    offset (the kernel's byte path). The l_comment plane is the shape
    timed."""
    import torch
    from spark_rapids_tpu_torch.ops import case_map as CM
    noise = torch.from_numpy(rng.integers(0, 256, 1 << 30, dtype=np.uint8)
                             ).to(dev)
    inputs = [plane, noise, noise[3:3 + (1 << 20) + 5]]
    inputs += [noise[:k] for k in (0, 1, 15, 17, 4095)]
    bad, err = [], 0
    for i, x in enumerate(inputs):
        for upper in (True, False):
            got, want = CM.case_map(x, upper), CM.case_map_plain(x, upper)
            if x.numel():
                err = max(err, int((got.to(torch.int16) - want.to(
                    torch.int16)).abs().max()))
            if not torch.equal(got, want):
                bad.append((i, x.numel(), upper))
    del noise, inputs, got, want
    if bad:
        raise AssertionError(f"case_map kernel differs from its plain "
                             f"version on (input, bytes, upper) {bad}")
    n = plane.numel()
    ms = time_ms(lambda: CM.case_map(plane, True))
    kernel_ms = kernel_device_ms(lambda: CM.case_map(plane, True),
                                 "case_map")
    plain_ms = time_ms(lambda: CM.case_map_plain(plane, True), reps=5)
    return {"name": "case_map", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/case_map.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:151",
            "shape": f"uint8[{n}] (l_comment's plane, 30M rows), upper",
            "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": 2 * n / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}


def bitslice_row(pq_path: str, rng, dev):
    """B3 bitslice against its plain version: random words with fields of
    1-32 bits, offsets on word starts (sh == 0), in the last word and past
    the plane (the clamp), on a ragged view too; then pq_q6's real shape,
    l_shipdate's dictionary codes of one 2^20-row row group, which is
    also the shape timed."""
    import pyarrow.parquet as pq
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import encoded as ENC
    from spark_rapids_tpu_torch.ops import bitslice as BS
    from spark_rapids_tpu_torch.ops import decode as D
    nw, n = 1 << 16, 1 << 20
    words = rng.integers(0, 2 ** 32, nw, dtype=np.uint64).astype(np.uint32)
    bitoff = rng.integers(0, nw * 32 + 4096, n).astype(np.int64)
    bitoff[:4096] = np.arange(4096) * 32
    bitoff[4096:4128] = (nw - 1) * 32 + np.arange(32)
    width = rng.integers(1, 33, n)
    width[:1024] = 32
    mask = ((np.int64(1) << width) - 1).astype(np.uint32)
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    b = torch.from_numpy(bitoff).to(dev)
    m = torch.from_numpy(mask.view(np.int32)).to(dev)

    def max_diff(x, y):
        return int(((x.to(torch.int64) & 0xFFFFFFFF)
                    - (y.to(torch.int64) & 0xFFFFFFFF)).abs().max())
    err = max(max_diff(BS.bitslice(w, b, m), BS.bitslice_plain(w, b, m)),
              max_diff(BS.bitslice(w, b[3:-5], m[3:-5]),
                       BS.bitslice_plain(w, b[3:-5], m[3:-5])))
    md = pq.ParquetFile(pq_path).metadata
    fields = [T.StructField("l_shipdate", T.INT32)]
    hb = next(ENC.read_encoded_batches(pq_path, md, [0], fields, 1 << 20))
    ec = ENC.upload(hb, {}, dev).columns[0]
    if ec.kind != "dict":
        raise AssertionError(f"l_shipdate is {ec.kind}, not dict codes")
    rw, rb, rm, _ = D.run_bits(ec.planes, "", dict(ec.meta)["vcap"])
    err = max(err, max_diff(BS.bitslice(rw, rb, rm),
                            BS.bitslice_plain(rw, rb, rm)))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"bitslice kernel differs from its plain "
                             f"version (max abs err {err})")
    bits = int(ec.planes["width"][0])
    # the words the fields lie in; the pool's power-of-two tail is not read
    words_read = min(rw.numel(), int(rb.max()) // 32 + 2)
    ms = time_ms(lambda: BS.bitslice(rw, rb, rm))
    kernel_ms = kernel_device_ms(lambda: BS.bitslice(rw, rb, rm), "bitslice")
    plain_ms = time_ms(lambda: BS.bitslice_plain(rw, rb, rm), reps=10)
    nbytes = rb.numel() * (8 + 4 + 4) + words_read * 4
    return {"name": "bitslice", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/bitslice.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_decode.py:64",
            "shape": f"words int32[{rw.numel()}] ({words_read} read), "
                     f"{rb.numel()} fields of {bits} bits (l_shipdate "
                     f"codes, one row group)",
            "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _close(a, b, tol=1e-6):
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def q6_reference(t) -> float:
    """bench.py's pyarrow q6."""
    import pyarrow.compute as pc
    m = pc.and_(pc.and_(pc.and_(pc.greater_equal(t["l_shipdate"], LO),
                                pc.less(t["l_shipdate"], HI)),
                        pc.and_(pc.greater_equal(t["l_discount"], 0.05),
                                pc.less_equal(t["l_discount"], 0.07))),
                pc.less(t["l_quantity"], 24.0))
    f = t.filter(m)
    return pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"])).as_py()


def q1_reference(t) -> dict:
    """bench.py's pyarrow q1: (returnflag, linestatus) -> sums, means and
    the count."""
    import pyarrow.compute as pc
    f = t.filter(pc.less_equal(t["l_shipdate"], 10471))
    g = f.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("l_quantity", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count")])
    return {(rf, ls): (sq, sp, mq, md, c)
            for rf, ls, sq, sp, mq, md, c in zip(*[g[n].to_pylist() for n in (
                "l_returnflag", "l_linestatus", "l_quantity_sum",
                "l_extendedprice_sum", "l_quantity_mean", "l_discount_mean",
                "l_quantity_count")])}


def host_reference(t):
    """bench.py's pyarrow baseline for the four queries."""
    import pyarrow as pa
    import pyarrow.compute as pc
    q6 = q6_reference(t)
    q1 = q1_reference(t)
    key = pa.chunked_array([np.mod(c.to_numpy(), 100_000)
                            for c in t["l_orderkey"].chunks])
    g = t.select(["l_quantity"]).append_column("k", key).group_by(
        ["k"]).aggregate([("l_quantity", "sum"), ("l_quantity", "count")])
    q72 = (g.num_rows, round(pc.sum(g["l_quantity_sum"]).as_py(), 2),
           int(pc.sum(g["l_quantity_count"]).as_py()))
    q72_groups = {k: (s, c) for k, s, c in zip(
        g["k"].to_pylist(), g["l_quantity_sum"].to_pylist(),
        g["l_quantity_count"].to_pylist())}
    g = t.group_by(["l_shipdate"]).aggregate([("l_quantity", "sum"),
                                              ("l_quantity", "count")])
    rep = {d: (s, c) for d, s, c in zip(g["l_shipdate"].to_pylist(),
                                        g["l_quantity_sum"].to_pylist(),
                                        g["l_quantity_count"].to_pylist())}
    return {"q6": q6, "q1": q1, "q72shfl": q72, "repart_agg": rep,
            "q72shfl_groups": q72_groups}


def port_queries(cached):
    from spark_rapids_tpu_torch.expr.core import col, lit
    from spark_rapids_tpu_torch.sql import functions as F

    def q6():
        cond = ((col("l_shipdate") >= lit(LO)) & (col("l_shipdate") < lit(HI))
                & (col("l_discount") >= lit(0.05))
                & (col("l_discount") <= lit(0.07))
                & (col("l_quantity") < lit(24.0)))
        out = cached.filter(cond).agg(
            F.sum(col("l_extendedprice") * col("l_discount")))
        return list(out.to_pydict().values())[0][0]

    def q1():
        d = (cached.filter(col("l_shipdate") <= lit(10471))
             .group_by("l_returnflag", "l_linestatus")
             .agg(F.sum(col("l_quantity")).alias("sq"),
                  F.sum(col("l_extendedprice")).alias("sp"),
                  F.avg(col("l_quantity")).alias("mq"),
                  F.avg(col("l_discount")).alias("md"),
                  F.count(col("l_quantity")).alias("cnt"))).to_pydict()
        return {(rf, ls): (sq, sp, mq, md, c) for rf, ls, sq, sp, mq, md, c in
                zip(d["l_returnflag"], d["l_linestatus"], d["sq"], d["sp"],
                    d["mq"], d["md"], d["cnt"])}

    def q72_grouped():
        return (cached.select((col("l_orderkey") % lit(100_000)).alias("k"),
                              col("l_quantity"))
                .group_by(col("k"))
                .agg(F.sum("l_quantity").alias("s"),
                     F.count("l_quantity").alias("c")))

    def q72shfl():
        # bench.py's shape: the grouped result is reduced on the device
        d = q72_grouped().agg(F.count(col("k")).alias("n"),
                              F.sum(col("s")).alias("ts"),
                              F.sum(col("c")).alias("tc")).to_pydict()
        return (int(d["n"][0]), round(float(d["ts"][0]), 2), int(d["tc"][0]))

    def q72shfl_groups():
        d = q72_grouped().to_pydict()
        return {k: (s, c) for k, s, c in zip(d["k"], d["s"], d["c"])}

    def repart_agg():
        d = (cached.select(col("l_shipdate"), col("l_quantity"))
             .repartition(8, col("l_shipdate"))
             .group_by(col("l_shipdate"))
             .agg(F.sum("l_quantity").alias("s"),
                  F.count("l_quantity").alias("c"))).to_pydict()
        return {k: (s, c) for k, s, c in zip(d["l_shipdate"], d["s"], d["c"])}

    return {"q6": q6, "q1": q1, "q72shfl": q72shfl, "repart_agg": repart_agg,
            "q72shfl_groups": q72shfl_groups}


def validate(name, got, want) -> bool:
    if name == "q6":
        return _close(got, want)
    if name == "q1":
        return set(got) == set(want) and all(
            all(_close(a, b) for a, b in zip(got[k][:4], want[k][:4]))
            and int(got[k][4]) == int(want[k][4]) for k in want)
    if name == "q72shfl":
        return got[0] == want[0] and _close(got[1], want[1]) \
            and got[2] == want[2]
    # repart_agg and q72shfl_groups: every group's sum and count
    return set(got) == set(want) and all(
        _close(got[k][0], want[k][0]) and got[k][1] == want[k][1]
        for k in want)


class RouteSpy:
    """Counts entries into an operator's routes while a path runs: by
    default the aggregate's (``_AggKernels``), or the given methods of
    ``cls``."""

    METHODS = ("_global_update", "_bucket_update", "_segsum_or_fallback",
               "_chunked_segsum_agg", "_scatter_agg", "_sort_agg",
               "_packed_sort_agg")

    def __init__(self, cls=None, methods=None):
        from spark_rapids_tpu_torch.exec import nodes as X
        self.cls = cls or X._AggKernels
        self.methods = methods or self.METHODS
        self.counts = {m: 0 for m in self.methods}
        self.orig = {m: getattr(self.cls, m) for m in self.methods}
        for m in self.methods:
            setattr(self.cls, m, self._wrap(m))

    def _wrap(self, m):
        orig = self.orig[m]

        def spy(kern, *a, **k):
            with SPY_LOCK:
                self.counts[m] += 1
            return orig(kern, *a, **k)
        return spy

    def take(self):
        with SPY_LOCK:
            out, self.counts = self.counts, {m: 0 for m in self.methods}
        return {k: v for k, v in out.items() if v}

    def restore(self):
        for m, orig in self.orig.items():
            setattr(self.cls, m, orig)


def phase_setup(rows: int, tmp_dir: str):
    """The lineitem and orders, the lineitem's pyarrow answers, and the
    Parquet file of it."""
    import pyarrow.parquet as pq
    t0 = time.perf_counter()
    table, orders = helpers().make_tables(rows)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = host_reference(table)
    host_s = time.perf_counter() - t0
    path = os.path.join(tmp_dir, "lineitem.parquet")
    t0 = time.perf_counter()
    pq.write_table(table, path, **PARQUET_WRITE)
    write_s = time.perf_counter() - t0
    groups = pq.ParquetFile(path).metadata.num_row_groups
    emit({"phase": "setup", "rows": rows, "generate_s": gen_s,
          "host_reference_s": host_s, "parquet_write_s": write_s,
          "parquet_bytes": os.path.getsize(path), "row_groups": groups})
    if groups != 29:
        raise AssertionError(f"{groups} row groups, expected 29")
    return table, orders, want, path


def reset_launches() -> None:
    from spark_rapids_tpu_torch.ops import bitslice as BS
    from spark_rapids_tpu_torch.ops import case_map as CM
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    MK.launches = S.launches = BS.launches = CM.launches = 0


def read_launches():
    from spark_rapids_tpu_torch.ops import bitslice as BS
    from spark_rapids_tpu_torch.ops import case_map as CM
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    return {"murmur3_int32": MK.launches, "segsum": S.launches,
            "bitslice": BS.launches, "case_map": CM.launches}


def phase_path(table, want, spy, prof=None):
    import torch
    rows = table.num_rows
    reset_launches()
    session = device_session()
    t0 = time.perf_counter()
    cached = session.create_dataframe(table).cache()
    n = cached.count()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    if n != rows:
        raise AssertionError(f"cached count {n} != {rows}")
    per_query = {}
    ok = True
    spy.take()
    for name, fn in port_queries(cached).items():
        before = read_launches()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        # one warm run (two until the fusion phase came)
        for _ in range(PATH_WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate(name, got, want[name])
        ok &= good
        runs = 1 + PATH_WARM_RUNS
        launches = {k: (v - before[k]) // runs
                    for k, v in read_launches().items()}
        per_query[name] = {"correct": good, "cold_s": cold,
                           "warm_s": min(warm), "launches": launches,
                           "routes": {k: v // runs for k, v in
                                      spy.take().items()}}
        emit({"phase": "path.query", "query": name, **per_query[name]})
    RUN_NOTES["path_q1_warm_ms"] = per_query["q1"]["warm_s"] * 1e3
    counts = read_launches()
    emit({"phase": "path", "cache_s": cache_s, "launches": counts,
          "correct": ok})
    if prof:
        prof.run("cached", port_queries(cached))
    if not ok:
        raise AssertionError("a path query disagrees with pyarrow")
    if min(counts["murmur3_int32"], counts["segsum"]) <= 0:
        raise AssertionError(f"a kernel did not run on the path: {counts}")
    if not per_query["q72shfl"]["routes"].get("_chunked_segsum_agg"):
        raise AssertionError("q72shfl did not reach the chunked segsum route")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the Parquet path
# ---------------------------------------------------------------------------

DECODE_OFF = {"spark.rapids.sql.decode.device.enabled": "false"}
FLAG_COLUMNS = {"l_returnflag", "l_linestatus"}


def parquet_queries(dev_session, host_session, path):
    """name -> (session, run, reference answer) over the Parquet file."""
    def query(session, cols, ref):
        return session, port_queries(session.read_parquet(
            path, columns=cols))[ref], ref
    return {
        "pq_q6": query(dev_session, Q6_COLS, "q6"),
        "pq_q6_host": query(host_session, Q6_COLS, "q6"),
        "pq_q1_mixed": query(dev_session, Q1_COLS, "q1"),
        "pq_repart_agg": query(dev_session, ["l_shipdate", "l_quantity"],
                               "repart_agg"),
    }


#: the operators whose counters the parquet phase prints
SCAN_EXECS = ("ParquetScanExec", "EncodedParquetSourceExec",
              "DeviceDecodeScanExec")


def scan_report(session):
    """The scan operators' counters of the session's last query, read
    through ``last_metrics()``: timers in seconds, and the decode timer
    (gpuDecodeTime) under its earlier key decodeTime."""
    out = {}
    for key, snap in session.last_metrics().items():
        name = key.split("#")[0]
        if name in SCAN_EXECS:
            out[name] = {("decodeTime" if k == "gpuDecodeTime" else k):
                         (v / 1e9 if k.endswith("Time") else v)
                         for k, v in snap.items()}
    for e in session.last_exec.walk():
        if hasattr(e, "fallback_columns"):
            out["fallback_columns"] = sorted(e.fallback_columns)
    return out


def phase_parquet(path, want, spy, prof=None):
    import pyarrow.parquet as pq
    groups = pq.ParquetFile(path).metadata.num_row_groups
    queries = parquet_queries(device_session(), device_session(DECODE_OFF),
                              path)
    reset_launches()
    spy.take()
    problems = []
    for name, (session, fn, ref) in queries.items():
        runs = []
        for _ in range(2):  # cold, then warm
            before = read_launches()
            t0 = time.perf_counter()
            got = fn()
            secs = time.perf_counter() - t0
            runs.append((secs, validate(ref, got, want[ref]),
                         {k: v - before[k]
                          for k, v in read_launches().items()}))
        scan = scan_report(session)
        if name == "pq_q6":  # the trace phase runs it again
            RUN_NOTES["pq_q6_warm_ms"] = runs[1][0] * 1e3
        routes = {k: v // 2 for k, v in spy.take().items()}
        good = all(r[1] for r in runs)
        if not good:
            problems.append(f"{name} disagrees with pyarrow")
        bits = [r[2]["bitslice"] for r in runs]
        if name == "pq_q6" and bits != [2 * groups] * 2:
            problems.append(f"pq_q6 launched bitslice {bits} times per run, "
                            f"expected {2 * groups}")
        if name == "pq_q6_host" and any(bits):
            problems.append(f"pq_q6_host launched bitslice {bits} times")
        if name == "pq_q1_mixed" \
                and set(scan.get("fallback_columns", ())) != FLAG_COLUMNS:
            problems.append(f"pq_q1_mixed fell back on "
                            f"{scan.get('fallback_columns')}")
        if name == "pq_repart_agg" and not routes.get("_chunked_segsum_agg"):
            problems.append("pq_repart_agg missed the chunked segsum route")
        emit({"phase": "parquet.query", "query": name, "correct": good,
              "cold_s": runs[0][0], "warm_s": runs[1][0],
              "launches_per_run": runs[1][2], "routes": routes,
              "scan": scan})
    counts = read_launches()
    emit({"phase": "parquet", "row_groups": groups, "launches": counts,
          "correct": not problems, "problems": problems})
    host_split(path, Q6_COLS)
    if prof:
        prof.run("parquet", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if min(counts[k] for k in ("murmur3_int32", "segsum", "bitslice")) <= 0:
        raise AssertionError(f"a kernel did not run on the Parquet path: "
                             f"{counts}")
    return counts


def host_split(path, cols) -> None:
    """Where the device-decode scan's host time goes: one pass of the
    encoded reader over ``cols`` (no upload), with page decompression
    timed apart from the rest (thrift headers, run parsing, plane
    assembly in Python)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import encoded as ENC
    spent = {"decompress_s": 0.0, "pages": 0}

    class TimedCodec:
        def __init__(self, codec):
            self.codec = codec

        def decompress(self, *a, **k):
            t0 = time.perf_counter()
            out = self.codec.decompress(*a, **k)
            spent["decompress_s"] += time.perf_counter() - t0
            spent["pages"] += 1
            return out

    md = pq.ParquetFile(path).metadata
    schema = pq.read_schema(path)
    fields = [T.StructField(c, T.from_arrow(schema.field(c).type))
              for c in cols]
    orig = ENC._codec
    ENC._codec = lambda name: (lambda c: c and TimedCodec(c))(orig(name))
    try:
        t0 = time.perf_counter()
        nbytes = sum(hb.encoded_bytes for hb in ENC.read_encoded_batches(
            path, md, list(range(md.num_row_groups)), fields, 1 << 20))
        total = time.perf_counter() - t0
    finally:
        ENC._codec = orig
    emit({"phase": "parquet.host", "columns": cols, "total_s": total,
          **spent, "rest_s": total - spent["decompress_s"],
          "encoded_bytes": nbytes})


# ---------------------------------------------------------------------------
# phase 6: device decode against pyarrow, exactly
# ---------------------------------------------------------------------------

def same_column(cv, ref, n: int) -> bool:
    """Equal planes over the whole capacity (values, the 0 fill of null
    rows, the zero tail) and equal validity; compared on the card, floats
    by their bits."""
    import torch
    a, b = cv.data, ref.data
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return bool(torch.equal(a, b)) and bool(torch.equal(
        cv.validity_or_default(n), ref.validity_or_default(n)))


def decode_file(path, dev, fallback_ok=frozenset()):
    """Decode every row group of a file on the card; returns (batches,
    mismatching (batch, column) pairs, {fallback column: reason})."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import column_from_arrow
    from spark_rapids_tpu_torch.io import encoded as ENC
    from spark_rapids_tpu_torch.ops import decode as D
    pf = pq.ParquetFile(path)
    md = pf.metadata
    fields = [T.StructField(f.name, T.from_arrow(f.type))
              for f in pf.schema_arrow]
    batches, bad, fell_back = 0, [], {}
    groups = list(range(md.num_row_groups))
    for hb in ENC.read_encoded_batches(path, md, groups, fields, 1 << 20):
        fell_back.update(hb.fallback)
        tbl = pf.read_row_groups(hb.groups).combine_chunks()

        def host(i):
            c = tbl.column(i)
            arr = c.chunk(0) if c.num_chunks else c.combine_chunks()
            return column_from_arrow(arr, fields[i].dtype, hb.cap, dev)
        fb = {i: host(i) for i, c in enumerate(hb.columns) if c is None}
        cb = D.decode_batch(ENC.upload(hb, fb, dev))
        for i, c in enumerate(hb.columns):
            if c is not None and not same_column(cb.columns[i], host(i),
                                                 hb.num_rows):
                bad.append((batches, fields[i].name))
        batches += 1
    if set(fell_back) != set(fallback_ok):
        bad.append(("fallback", fell_back))
    return batches, bad, fell_back


def matrix_column(rng, n, kind):
    """tests/test_device_decode.py's column generator."""
    import pyarrow as pa
    if kind == "i32_dict":
        return pa.array(rng.choice([3, 7, 11, 42, -5], n).astype(np.int32))
    if kind == "i64_plain":
        return pa.array(rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64))
    if kind == "f64":
        return pa.array(rng.normal(size=n))
    if kind == "f32":
        return pa.array(rng.normal(size=n).astype(np.float32))
    if kind == "bool":
        return pa.array(rng.random(n) < 0.5)
    if kind == "i32_wide":
        return pa.array(rng.integers(-2 ** 30, 2 ** 30, n).astype(np.int32))
    if kind == "i64_delta":
        return pa.array(np.cumsum(rng.integers(0, 50, n)).astype(np.int64))
    raise AssertionError(kind)


def with_nulls(rng, arr, density):
    import pyarrow as pa
    if density == "none":
        return arr
    frac = {"sparse": 0.1, "all": 1.0}[density]
    mask = rng.random(len(arr)) < frac if frac < 1.0 \
        else np.ones(len(arr), bool)
    return pa.array(arr.to_numpy(zero_copy_only=False), type=arr.type,
                    mask=mask)


def matrix_files(n: int):
    """(name, table, writer settings) of the decode matrix."""
    import pyarrow as pa
    rng = np.random.default_rng(7)
    kinds = ("i32_dict", "i64_plain", "f64", "f32", "bool", "i32_wide")
    out = []
    for nulls in ("sparse", "all"):
        out.append((f"mixed_{nulls}", pa.table(
            {k: with_nulls(rng, matrix_column(rng, n, k), nulls)
             for k in kinds}),
            dict(compression="snappy", row_group_size=n // 4,
                 use_dictionary=["i32_dict"], data_page_size=1 << 16,
                 data_page_version="1.0")))
    for nulls in ("none", "sparse"):
        out.append((f"delta_{nulls}", pa.table(
            {"d": with_nulls(rng, matrix_column(rng, n, "i64_delta"),
                             nulls)}),
            dict(use_dictionary=False,
                 column_encoding={"d": "DELTA_BINARY_PACKED"},
                 row_group_size=n // 4, data_page_size=1 << 14,
                 data_page_version="1.0")))
    runs = np.repeat(rng.random(n // 256) < 0.5, 128)
    out.append(("bool_rle", pa.table({"b": np.concatenate(
        [runs, rng.random(n - len(runs)) < 0.5])}),
        dict(use_dictionary=False, column_encoding={"b": "RLE"},
             data_page_version="1.0")))
    out.append(("date_timestamp", pa.table({
        "d": pa.array(rng.integers(8000, 12000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 2 ** 48, n).astype(np.int64),
                       pa.timestamp("us"))}),
        # a dictionary of 2^20 distinct timestamps overflows, and pyarrow
        # then switches the chunk to PLAIN part way (a per-column
        # fallback): write the high-entropy column PLAIN outright
        dict(use_dictionary=["d"], data_page_version="1.0")))
    return out


def phase_decode(path, tmp_dir, dev):
    import pyarrow.parquet as pq
    t0 = time.perf_counter()
    batches, bad, fell_back = decode_file(path, dev, FLAG_COLUMNS)
    emit({"phase": "decode.file", "batches": batches, "mismatches": bad,
          "fallback_columns": sorted(fell_back),
          "seconds": time.perf_counter() - t0})
    if bad or batches != 29:
        raise AssertionError(f"device decode of the lineitem file differs "
                             f"from pyarrow: {batches} batches, {bad}")
    n = 1 << 20
    for name, table, kw in matrix_files(n):
        t0 = time.perf_counter()
        mpath = os.path.join(tmp_dir, f"{name}.parquet")
        pq.write_table(table, mpath, **kw)
        batches, bad, _ = decode_file(mpath, dev)
        emit({"phase": "decode.matrix", "file": name, "rows": n,
              "batches": batches, "mismatches": bad,
              "seconds": time.perf_counter() - t0})
        if bad or batches != 1:
            raise AssertionError(f"device decode of {name} differs from "
                                 f"pyarrow: {batches} batches, {bad}")


# ---------------------------------------------------------------------------
# phase 7: string expressions over a flat column
# ---------------------------------------------------------------------------

def strings_reference(t):
    """pyarrow's answers with its ASCII string functions, which are what
    the port's device path computes."""
    import pyarrow as pa
    import pyarrow.compute as pc
    c = t["l_comment"]
    up, low = pc.ascii_upper(c), pc.ascii_lower(c)
    f = t.append_column("n_chars", pc.utf8_length(low)).filter(
        pc.match_substring(up, helpers().CASE_WORD))
    g = f.group_by(["l_returnflag", "l_linestatus"]).aggregate(
        [("n_chars", "count"), ("n_chars", "sum")])
    case_agg = {(a, b): (n, s) for a, b, n, s in zip(
        *[g[k].to_pylist() for k in ("l_returnflag", "l_linestatus",
                                     "n_chars_count", "n_chars_sum")])}
    heads = t.select(["l_quantity"]).append_column(
        "head", pc.utf8_slice_codeunits(up, 0, 9))
    g = heads.group_by(["head"]).aggregate([("l_quantity", "count"),
                                            ("l_quantity", "sum")])
    group_flat = g.select(["head", "l_quantity_count", "l_quantity_sum"]) \
        .rename_columns(["head", "n", "q"]).cast(pa.schema([
            ("head", pa.string()), ("n", pa.int64()), ("q", pa.float64())])) \
        .sort_by("head")
    m = pc.and_(pc.starts_with(low, helpers().PREFIX_WORD),
                pc.less(t["l_quantity"], 3.0))
    r = t.filter(m)
    flags = pc.binary_join_element_wise(r["l_returnflag"],
                                        r["l_linestatus"], "|")
    rows = r.select(["l_orderkey"]).append_column("flags", flags) \
        .append_column("head", pc.utf8_slice_codeunits(
            pc.ascii_upper(r["l_comment"]), 0, 12))
    return {"str_case_agg": case_agg, "str_group_flat": group_flat,
            "str_prefix_rows": _sorted_rows(rows)}


def _sorted_rows(t):
    import pyarrow as pa
    t = t.rename_columns(["l_orderkey", "flags", "head"]).cast(pa.schema([
        ("l_orderkey", pa.int64()), ("flags", pa.string()),
        ("head", pa.string())]))
    return t.sort_by([("l_orderkey", "ascending"), ("flags", "ascending"),
                      ("head", "ascending")])


def string_queries(cached):
    """The three string shapes of tests/torch_port_helpers.py over the
    cached lineitem_text; str_case_agg's groups come back as a dict."""
    H, api = helpers(), port_api()

    def str_case_agg():
        d = H.str_case_agg(api, cached).to_pydict()
        return {(a, b): (n, c) for a, b, n, c in zip(
            d["l_returnflag"], d["l_linestatus"], d["n"], d["chars"])}

    return {"str_case_agg": str_case_agg,
            "str_group_flat": lambda: H.str_group_flat(api, cached).collect(),
            "str_prefix_rows": lambda: H.str_prefix_rows(api, cached)
            .collect()}


def validate_strings(name, got, want) -> bool:
    """Sorts the port's tables (outside the timed runs) and compares."""
    if name == "str_case_agg":
        return got == want
    if name == "str_prefix_rows":
        got = _sorted_rows(got)
    if name == "str_group_flat":
        got = got.sort_by("head")
        if got.num_rows != want.num_rows:
            return False
        q_got = got["q"].to_numpy()
        q_want = want["q"].to_numpy()
        return (got["head"].equals(want["head"])
                and got["n"].equals(want["n"].cast(got["n"].type))
                and bool(np.all(np.abs(q_got - q_want)
                                <= 1e-6 * np.maximum(1.0, np.abs(q_want)))))
    return got.num_rows == want.num_rows and all(
        got[k].equals(want[k].cast(got[k].type)) for k in got.column_names)


def phase_strings(text, spy, prof=None):
    import torch
    t0 = time.perf_counter()
    want = strings_reference(text)
    host_s = time.perf_counter() - t0
    reset_launches()
    spy.take()
    session = device_session()
    t0 = time.perf_counter()
    cached = session.create_dataframe(text).cache()
    n = cached.count()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    comment = cached.plan.materialized[0][0].get_batch().columns[-1]
    if n != text.num_rows or "offsets" not in comment.data:
        raise AssertionError(f"lineitem_text cached {n} rows; l_comment "
                             f"planes {sorted(comment.data)}")
    emit({"phase": "strings.setup", "rows": n, "host_reference_s": host_s,
          "cache_s": cache_s,
          "comment_bytes": int(comment.data["offsets"][-1]),
          "comment_plane": comment.data["bytes"].numel()})
    problems = []
    queries = string_queries(cached)
    for name, fn in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_strings(name, got, want[name])
        if not good:
            problems.append(f"{name} disagrees with pyarrow")
        launches = {k: (v - before[k]) // 3
                    for k, v in read_launches().items()}
        emit({"phase": "strings.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm), "launches": launches,
              "routes": {k: v // 3 for k, v in spy.take().items()},
              "result_rows": (len(got) if isinstance(got, dict)
                              else got.num_rows),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "strings", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("strings", queries)
    if problems:
        raise AssertionError("; ".join(problems))
    if counts["case_map"] <= 0:
        raise AssertionError(f"the case-map kernel did not run on the "
                             f"strings path: {counts}")
    return counts, cached.plan


# ---------------------------------------------------------------------------
# phase 8: joins, sort, TopN and limit
# ---------------------------------------------------------------------------

SORT_KEYS = [("l_extendedprice", "descending"), ("l_orderkey", "ascending"),
             ("l_shipdate", "ascending")]


def joins_reference(t, orders):
    """pyarrow's answers to the join and sort shapes (bench.py's q3join
    baseline, extended to the other shapes)."""
    import pyarrow.compute as pc
    li = t.select(["l_orderkey", "l_shipdate", "l_extendedprice",
                   "l_discount"])
    li = li.filter(pc.greater(li["l_shipdate"], 9100))
    od = orders.filter(pc.less(orders["o_orderdate"], 9500))
    j = li.join(od, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    j = j.append_column("rev", pc.multiply(
        j["l_extendedprice"], pc.subtract(1.0, j["l_discount"])))
    g = j.group_by(["l_orderkey", "o_orderdate"]).aggregate([("rev", "sum")])
    top = g.take(pc.select_k_unstable(g, 10, [("rev_sum", "descending"),
                                              ("l_orderkey", "ascending")]))
    q3 = dict(zip(zip(top["l_orderkey"].to_pylist(),
                      top["o_orderdate"].to_pylist()),
                  top["rev_sum"].to_pylist()))
    g = j.group_by(["o_orderdate"]).aggregate([("rev", "sum"),
                                               ("rev", "count")])
    by_date = {d: (r, n) for d, r, n in zip(
        *[g[k].to_pylist() for k in ("o_orderdate", "rev_sum",
                                     "rev_count")])}
    o = orders.filter(pc.and_(pc.greater_equal(orders["o_orderdate"], 9000),
                              pc.less(orders["o_orderdate"], 9400)))
    shipped = pc.unique(t.filter(pc.greater(t["l_shipdate"], 9100))[
        "l_orderkey"])
    m = pc.is_in(o["o_orderkey"], value_set=shipped)
    q4 = {how: (part.num_rows, pc.sum(part["o_custkey"]).as_py())
          for how, part in (("left_semi", o.filter(m)),
                            ("left_anti", o.filter(pc.invert(m))))}
    early = orders.filter(pc.less(orders["o_orderdate"], 8500))
    per = np.bincount(early["o_custkey"].to_numpy(),
                      minlength=max(orders.num_rows // 10, 10))
    c_count, custdist = np.unique(per, return_counts=True)
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate(
        [("l_extendedprice", "sum"), ("l_extendedprice", "count")])
    flag = {helpers().FLAG_LABELS[(a, b)]: (p, n) for a, b, p, n in zip(
        *[g[k].to_pylist() for k in ("l_returnflag", "l_linestatus",
                                     "l_extendedprice_sum",
                                     "l_extendedprice_count")])}
    cols = [k for k, _ in SORT_KEYS]
    ordered = t.select(cols).take(pc.sort_indices(t, SORT_KEYS))
    bands = helpers().make_bands()
    price = t["l_extendedprice"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    lo, hi = bands["lo"].to_numpy(), bands["hi"].to_numpy()
    b = np.searchsorted(lo, price, side="right") - 1
    inside = (b >= 0) & (price < hi[b.clip(0)])
    n_band = np.bincount(b[inside], minlength=len(lo))
    q_band = np.bincount(b[inside], weights=qty[inside], minlength=len(lo))
    few = int(((qty < 2.0) & (t["l_shipdate"].to_numpy() < 8500)).sum())
    return {"band_join": {k: (int(n_band[k]), float(q_band[k]))
                          for k in range(len(lo)) if n_band[k]},
            "flag_cross": {v: few for v in helpers().FLAG_LABELS.values()},
            "q3join": {k: v for (k, _), v in q3.items()},
            "q3join_shuffled": {k: v for (k, _), v in q3.items()},
            "q3_orderdate": q3, "q3_revenue_by_date": by_date,
            "q4_semi_anti": q4,
            "q13_left": dict(zip(c_count.tolist(), custdist.tolist())),
            "flag_dim": flag, "sort_rows": ordered.combine_chunks()}


def joins_queries(h1, h8):
    """name -> (session, run): the join and sort shapes of
    tests/torch_port_helpers.py over the 1-partition caches (h1) and the
    8-partition ones (h8), each run returning what validate_joins reads."""
    H, api = helpers(), port_api()

    def top(df, keys):
        d = df.to_pydict()
        return {tuple(d[k][i] for k in keys) if len(keys) > 1
                else d[keys[0]][i]: d["rev"][i] for i in range(len(d["rev"]))}

    def by_date():
        d = H.q3_revenue_by_date(api, h1.li, h1.od).to_pydict()
        return {k: (r, n) for k, r, n in zip(d["o_orderdate"], d["rev"],
                                             d["n"])}

    def q4():
        out = {}
        for how in ("left_semi", "left_anti"):
            d = H.q4_semi_anti(api, h1.li, h1.od, how).to_pydict()
            out[how] = (d["n"][0], d["cs"][0])
        return out

    def q13():
        d = H.q13_left(api, h1.cust, h1.od).to_pydict()
        return dict(zip(d["c_count"], d["custdist"]))

    def flag():
        d = H.flag_dim(api, h1.li, h1.dim).to_pydict()
        return {k: (p, n) for k, p, n in zip(d["d_label"], d["price"],
                                             d["n"])}

    def band():
        d = H.band_join(api, h1.li, h1.bands).to_pydict()
        return {k: (n, q) for k, n, q in zip(d["band"], d["n"], d["q"])}

    def cross():
        d = H.flag_cross(api, h1.li, h1.dim).to_pydict()
        return dict(zip(d["d_label"], d["n"]))

    return {
        "q3join": (h1.s, lambda: top(H.q3join(api, h1.li, h1.od),
                                     ["l_orderkey"])),
        "q3join_shuffled": (h8.s, lambda: top(H.q3join(api, h8.li, h8.od),
                                              ["l_orderkey"])),
        "q3_orderdate": (h1.s, lambda: top(H.q3_orderdate(api, h1.li, h1.od),
                                           ["l_orderkey", "o_orderdate"])),
        "q3_revenue_by_date": (h1.s, by_date),
        "q4_semi_anti": (h1.s, q4),
        "q13_left": (h1.s, q13),
        "flag_dim": (h1.s, flag),
        "band_join": (h1.s, band),
        "flag_cross": (h1.s, cross),
        "sort_rows": (h8.s, lambda: H.sort_rows(api, h8.li).collect()),
        "limit_rows": (h8.s, lambda: H.limit_rows(api, h8.li).collect()),
    }


def validate_joins(name, got, want) -> bool:
    if name == "limit_rows":
        q = got["l_quantity"].to_numpy()
        return got.num_rows == 1000 and bool((q < 2.0).all())
    if name == "sort_rows":
        got = got.combine_chunks()
        return got.num_rows == want.num_rows and all(
            got[k].equals(want[k]) for k in want.column_names)
    if name in ("q4_semi_anti", "q13_left", "flag_cross"):
        return got == want
    if set(got) != set(want):
        return False
    if name == "q3_revenue_by_date":
        return all(_close(got[k][0], want[k][0], 1e-9)
                   and got[k][1] == want[k][1] for k in want)
    if name == "band_join":
        return all(got[k][0] == want[k][0] and _close(got[k][1], want[k][1])
                   for k in want)
    if name == "flag_dim":
        return all(_close(got[k][0], want[k][0])
                   and got[k][1] == want[k][1] for k in want)
    return all(_close(got[k], want[k], 1e-9) for k in want)


class JoinSpy:
    """Counts the probe path each join took: the unique-key mask-through
    probe (dense_unique), the direct-address pairs (dense_pairs), the
    general sort-merge pairs (general), and build splits (split)."""

    def __init__(self):
        from spark_rapids_tpu_torch.exec import nodes as X
        from spark_rapids_tpu_torch.ops import join as J
        self.targets = {"dense_unique": (X._HashJoinBase, "_probe_masked"),
                        "dense_pairs": (J, "_dense_int_pairs"),
                        "general": (J, "_merge_rank_ranges"),
                        "split": (X._HashJoinBase, "_split_build")}
        self.counts = {k: 0 for k in self.targets}
        for k, (owner, name) in self.targets.items():
            setattr(owner, name, self._wrap(k, getattr(owner, name)))

    def _wrap(self, key, orig):
        def spy(*a, **k):
            with SPY_LOCK:
                self.counts[key] += 1
            return orig(*a, **k)
        return spy

    def take(self):
        with SPY_LOCK:
            out, self.counts = self.counts, {k: 0 for k in self.targets}
        return {k: v for k, v in out.items() if v}


def _exec_names(session):
    names = []
    for e in session.last_exec.walk():
        if type(e).__name__ not in names:
            names.append(type(e).__name__)
    return names


#: what each join query must have run: (operators, aggregate routes,
#: join paths), each a set that must be present
JOIN_EXPECT = {
    "q3join": ({"BroadcastHashJoinExec", "TopNExec"}, set(),
               {"dense_unique"}),
    "q3join_shuffled": ({"ShuffledHashJoinExec", "ShuffleExchangeExec",
                         "TopNExec"}, set(), {"dense_unique"}),
    "q3_orderdate": ({"BroadcastHashJoinExec", "TopNExec"},
                     {"_packed_sort_agg"}, {"dense_unique"}),
    "q3_revenue_by_date": ({"BroadcastHashJoinExec"},
                           {"_chunked_segsum_agg"}, {"dense_unique"}),
    "q4_semi_anti": ({"BroadcastHashJoinExec"}, set(),
                     {"split", "dense_pairs"}),
    "q13_left": ({"BroadcastHashJoinExec"}, set(), {"dense_pairs"}),
    "flag_dim": ({"BroadcastHashJoinExec"}, set(), {"general"}),
    "band_join": ({"BroadcastNestedLoopJoinExec"}, set(), set()),
    "flag_cross": ({"CartesianProductExec"}, set(), set()),
    "sort_rows": ({"RangeExchangeExec", "SortExec"}, set(), set()),
    "limit_rows": ({"LimitExec", "CollectExchangeExec"}, set(), set()),
}


def phase_joins(table, orders, spy, prof=None):
    import torch
    from types import SimpleNamespace

    H = helpers()
    t0 = time.perf_counter()
    want = joins_reference(table, orders)
    host_s = time.perf_counter() - t0
    jspy = JoinSpy()
    reset_launches()
    spy.take()
    t0 = time.perf_counter()
    s1 = device_session()
    h1 = SimpleNamespace(s=s1, li=s1.create_dataframe(table).cache(),
                         od=s1.create_dataframe(orders).cache(),
                         cust=s1.create_dataframe(
                             H.make_customers(orders)).cache(),
                         dim=s1.create_dataframe(H.make_flag_dim()),
                         bands=s1.create_dataframe(H.make_bands()))
    # both thresholds 0: planned shuffled, and not demoted to a broadcast
    # at run time (the adaptive phase demotes the same join)
    s8 = device_session({"spark.rapids.sql.join.broadcastRowThreshold": 0,
                         "spark.rapids.sql.adaptive.broadcastThresholdBytes":
                         0})
    h8 = SimpleNamespace(s=s8, li=s8.create_dataframe(
        table, num_partitions=8).cache(), od=s8.create_dataframe(
        orders, num_partitions=8).cache())
    counts = [df.count() for df in (h1.li, h1.od, h1.cust, h8.li, h8.od)]
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    if counts != [table.num_rows, orders.num_rows,
                  max(orders.num_rows // 10, 10), table.num_rows,
                  orders.num_rows]:
        raise AssertionError(f"cached counts {counts}")
    emit({"phase": "joins.setup", "lineitem_rows": table.num_rows,
          "orders_rows": orders.num_rows, "host_reference_s": host_s,
          "cache_s": cache_s})
    problems = []
    queries = joins_queries(h1, h8)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_joins(name, got, want.get(name))
        if name == "q3join_shuffled":  # the trace phase runs it again
            RUN_NOTES["q3join_shuffled_warm_ms"] = min(warm) * 1e3
        routes = {k: v // RUNS for k, v in spy.take().items()}
        paths = {k: v // RUNS for k, v in jspy.take().items()}
        execs = _exec_names(session)
        e_ops, e_routes, e_paths = JOIN_EXPECT[name]
        if not good:
            problems.append(f"{name} disagrees with pyarrow")
        if not (e_ops <= set(execs) and e_routes <= set(routes)
                and e_paths <= set(paths)):
            problems.append(f"{name} ran {execs}, routes {routes}, join "
                            f"paths {paths}; expected {JOIN_EXPECT[name]}")
        emit({"phase": "joins.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm),
              "launches": {k: (v - before[k]) // RUNS
                           for k, v in read_launches().items()},
              "routes": routes, "join_paths": paths, "execs": execs,
              "result_rows": (got.num_rows if hasattr(got, "num_rows")
                              else len(got)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    RUN_NOTES["q3join_shuffled_want"] = want["q3join_shuffled"]
    emit({"phase": "joins", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("joins", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if counts["segsum"] <= 0:
        raise AssertionError(f"the segsum kernel did not run on the joins "
                             f"path: {counts}")
    return counts, h1, h8, want


# ---------------------------------------------------------------------------
# phase 8b: adaptive execution, the masked exchange and the hash functions
# ---------------------------------------------------------------------------

_U32, _U64 = np.uint32, np.uint64


def _rotl32(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _mm_k1(k):
    return _rotl32(k * _U32(0xCC9E2D51), 15) * _U32(0x1B873593)


def _mm_h1(h, k):
    return _rotl32(h ^ k, 13) * _U32(5) + _U32(0xE6546B64)


def _mm_fmix(h, n):
    h = h ^ _U32(n)
    h = (h ^ (h >> _U32(16))) * _U32(0x85EBCA6B)
    h = (h ^ (h >> _U32(13))) * _U32(0xC2B2AE35)
    return h ^ (h >> _U32(16))


def np_murmur3_int(v, seed):
    """Spark's Murmur3 hashInt of int32 values (uint32 arithmetic)."""
    return _mm_fmix(_mm_h1(seed, _mm_k1(v.astype(np.int32).view(_U32))), 4)


def np_murmur3_long(v, seed):
    """Spark's Murmur3 hashLong of int64 values: low word, high word."""
    u = v.astype(np.int64).view(_U64)
    low = (u & _U64(0xFFFFFFFF)).astype(_U32)
    high = (u >> _U64(32)).astype(_U32)
    return _mm_fmix(_mm_h1(_mm_h1(seed, _mm_k1(low)), _mm_k1(high)), 8)


_XX = [_U64(p) for p in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                         0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                         0x27D4EB2F165667C5)]


def _rotl64(x, r):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def np_xxhash64_long(bits, seed):
    """Spark's XXH64 hashLong of 64-bit patterns (uint64 arithmetic)."""
    p1, p2, p3, p4, p5 = _XX
    h = seed + p5 + _U64(8)
    h = h ^ (_rotl64(bits * p2, 31) * p1)
    h = _rotl64(h, 27) * p1 + p4
    h = (h ^ (h >> _U64(33))) * p2
    h = (h ^ (h >> _U64(29))) * p3
    return h ^ (h >> _U64(32))


def _double_bits(x):
    return np.where(x == 0.0, 0.0, x).astype(np.float64).view(_U64)


#: the adaptive phase's skewed key: 60% of the lines share key 0
SKEW_QTY = 30.0


def adaptive_reference(t, orders):
    """numpy's answers to the adaptive phase's queries."""
    ok = t["l_orderkey"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    price = t["l_extendedprice"].to_numpy()
    ship = t["l_shipdate"].to_numpy()
    odate = orders["o_orderdate"].to_numpy()
    per_day = np.bincount(odate - 8400, minlength=2200)
    key = np.where(qty <= SKEW_QTY, 0, ok).astype(np.int64)
    pid = np.mod(np_murmur3_long(key, _U32(42)).view(np.int32), 8)
    seed = np_murmur3_long(ok, _U32(42))
    seed = np_murmur3_int(qty.astype(np.int32), seed)
    h = np_murmur3_int(ship, seed).view(np.int32)
    x = np_xxhash64_long(ok.astype(np.int64).view(_U64), _U64(42))
    x = np_xxhash64_long(_double_bits(qty), x)
    x = np_xxhash64_long(_double_bits(price), x).view(np.int64)
    counts = np.bincount(key, minlength=orders.num_rows)
    sums = np.bincount(key, weights=price, minlength=orders.num_rows)
    present = np.flatnonzero(counts)
    return {"demote_build_rows": int((odate < 9500).sum()),
            "stays_shuffled": (t.num_rows, float(price.sum())),
            "row_probe": (t.num_rows, int(per_day[ship - 8400].sum())),
            "row_probe_build_rows": int((per_day > 0).sum()),
            "skew_totals": np.bincount(pid, minlength=8).tolist(),
            "skew": (present, counts[present], sums[present]),
            "hash": h, "xxhash64": x}


def adaptive_queries(h1, h8):
    """name -> (session, run): the adaptive phase's queries over the joins
    phase's caches, bound to sessions at the port's defaults (test mode),
    each run returning (result, the session's last_aqe())."""
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame

    H, api = helpers(), port_api()
    col, lit, F, T = api.col, api.lit, api.F, api.T
    s = device_session()
    demote = device_session({"spark.rapids.sql.join.broadcastRowThreshold":
                             0})
    masked = device_session({"spark.rapids.shuffle.partitioning": "masked"})

    def on(session, df):
        return DataFrame(df.plan, session)

    def run(session, query):
        return lambda: (query(), session.last_aqe())

    def top(df):
        d = df.to_pydict()
        return dict(zip(d["l_orderkey"], d["rev"]))

    def pair(df):
        d = df.to_pydict()
        return tuple(d[k][0] for k in d)

    def stays():
        li = on(s, h8.li).select(col("l_orderkey"), col("l_extendedprice"))
        return on(s, h8.od).join(
            li, on=[(col("o_orderkey"), col("l_orderkey"))]).agg(
            F.count().alias("n"), F.sum(col("l_extendedprice")).alias("p"))

    def row_probe():
        days = on(s, h8.od).group_by(col("o_orderdate")).agg(
            F.count().alias("n_orders"))
        return on(s, h8.li).join(
            days, on=[(col("l_shipdate"), col("o_orderdate"))]).agg(
            F.count().alias("n"), F.sum(col("n_orders")).alias("s"))

    def skew():
        key = F.when(col("l_quantity") <= lit(SKEW_QTY), lit(0)).otherwise(
            col("l_orderkey")).alias("k")
        t = on(s, h1.li).select(key, col("l_extendedprice")).repartition(
            8, col("k")).group_by(col("k")).agg(
            F.count().alias("n"), F.sum(col("l_extendedprice")).alias("p")) \
            .collect()
        order = np.argsort(t["k"].to_numpy())
        return tuple(t[c].to_numpy()[order] for c in ("k", "n", "p"))

    def hashes():
        t = on(s, h1.li).select(
            F.hash(col("l_orderkey"), col("l_quantity").cast(T.INT32),
                   col("l_shipdate")).alias("h"),
            F.xxhash64(col("l_orderkey"), col("l_quantity"),
                       col("l_extendedprice")).alias("x")).collect()
        return t["h"].to_numpy(), t["x"].to_numpy()

    def repart(session):
        d = H.repart_agg(api, on(session, h1.li)).to_pydict()
        return {k: (v, c) for k, v, c in zip(d["l_shipdate"], d["s"],
                                             d["c"])}

    return {
        "aqe_demote": (demote, run(demote, lambda: top(H.q3join(
            api, on(demote, h8.li), on(demote, h8.od))))),
        "aqe_stays_shuffled": (s, run(s, lambda: pair(stays()))),
        "aqe_row_probe": (s, run(s, lambda: pair(row_probe()))),
        "aqe_skew": (s, run(s, skew)),
        "hash_exprs": (s, run(s, hashes)),
        "compact_repart": (s, run(s, lambda: repart(s))),
        "masked_repart": (masked, run(masked, lambda: repart(masked))),
    }


class SeedSpy:
    """Counts the murmur3 kernel's calls by seed form (a per-row plane or
    a scalar)."""

    def __init__(self):
        from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
        self.mk, self.orig = MK, MK.murmur3_int32
        self.counts = {"per_row": 0, "scalar": 0}

        def spy(values, seed):
            import torch
            form = "per_row" if isinstance(seed, torch.Tensor) else "scalar"
            with SPY_LOCK:
                self.counts[form] += 1
            return self.orig(values, seed)
        MK.murmur3_int32 = spy

    def take(self):
        with SPY_LOCK:
            out, self.counts = self.counts, {"per_row": 0, "scalar": 0}
        return out

    def restore(self):
        self.mk.murmur3_int32 = self.orig


def _exchange_runs(session):
    """(exchange class, its output partitions, partitioning dispatches,
    host fetches, merged tiny sub-batches) of every exchange the last
    run partitioned."""
    return [(type(e).__name__, e.n_out, e.partition_dispatches,
             e.partition_fetches, e.coalesced_batches)
            for e in session.last_exec.walk()
            if hasattr(e, "partition_dispatches") and e._out is not None]


def validate_adaptive(name, got, want, aqe, warm_aqe, conf) -> list:
    """The problems of one adaptive query's answer and decisions."""
    from spark_rapids_tpu_torch.exec import adaptive as AQ
    kinds = [d["kind"] for d in (aqe or {}).get("decisions", [])]
    warm_kinds = [d["kind"] for d in (warm_aqe or {}).get("decisions", [])]
    out = []
    if name == "aqe_demote":
        if set(got) != set(want["q3join"]) or not all(
                _close(got[k], want["q3join"][k], 1e-9) for k in got):
            out.append("answer")
        (d,) = aqe["decisions"] if kinds == ["broadcast_conversion"] \
            else [None]
        if d is None or not (d["build_bytes"] <= d["threshold_bytes"]
                             == 64 << 20) or d["n_out"] != 8 \
                or d["build_rows"] != want["demote_build_rows"]:
            out.append(f"decisions {aqe}")
        if warm_kinds != ["broadcast_conversion", "build_reuse"]:
            out.append(f"warm decisions {warm_aqe}")
    elif name in ("aqe_stays_shuffled", "aqe_row_probe"):
        key = "stays_shuffled" if name == "aqe_stays_shuffled" \
            else "row_probe"
        n, v = want[key]
        if got[0] != n or not _close(got[1], v, 1e-9):
            out.append(f"answer {got} != {want[key]}")
        expect = [] if name == "aqe_stays_shuffled" \
            else [{"kind": "broadcast_conversion", "source": "row_probe",
                   "build_rows": want["row_probe_build_rows"],
                   "threshold_rows": 1 << 22, "dispatches_saved": 2}]
        for doc in (aqe, warm_aqe):
            if (doc or {}).get("decisions", []) != expect:
                out.append(f"decisions {doc}")
    elif name == "aqe_skew":
        k, n, p = want["skew"]
        if not (np.array_equal(got[0], k) and np.array_equal(got[1], n)
                and np.allclose(got[2], p, rtol=1e-9, atol=0)):
            out.append("answer")
        totals = want["skew_totals"]
        threshold, median = AQ.skew_threshold(conf, totals)
        hot = int(np.argmax(totals))
        rows = totals[hot]
        step = max(median, -(-rows // 8))
        expect = [{"kind": "skew_split", "partition": hot, "rows": rows,
                   "median": median, "threshold_rows": threshold,
                   "splits": -(-rows // step)}]
        for doc in (aqe, warm_aqe):
            if (doc or {}).get("decisions") != expect:
                out.append(f"decisions {doc}, expected {expect}")
    elif name == "hash_exprs":
        if not (np.array_equal(got[0], want["hash"])
                and np.array_equal(got[1], want["xxhash64"])):
            out.append("hashes differ from numpy's")
    elif name == "masked_repart":
        if got != want["compact_repart"]:
            out.append("masked answer differs from the compact one")
    elif name == "compact_repart":
        if not validate("repart_agg", got, want["repart_agg"]):
            out.append("answer")
    if name not in ("aqe_demote", "aqe_stays_shuffled", "aqe_row_probe",
                    "aqe_skew") and (aqe or warm_aqe):
        out.append(f"unexpected decisions {aqe}")
    return [f"{name}: {p}" for p in out]


#: what each adaptive query must have run: operators that must be present
ADAPTIVE_EXPECT = {
    "aqe_demote": {"AdaptiveShuffledHashJoinExec", "BroadcastHashJoinExec",
                   "_MaterializedExec", "TopNExec"},
    "aqe_stays_shuffled": {"AdaptiveShuffledHashJoinExec",
                           "ShuffledHashJoinExec", "ShuffleExchangeExec"},
    "aqe_row_probe": {"AdaptiveJoinExec", "BroadcastHashJoinExec",
                      "_MaterializedExec"},
    "aqe_skew": {"ShuffleExchangeExec", "HashAggregateExec"},
    "hash_exprs": {"ProjectExec"},
    "compact_repart": {"ShuffleExchangeExec"},
    "masked_repart": {"ShuffleExchangeExec"},
}


def phase_adaptive(table, orders, want, jwant, h1, h8, spy, prof=None):
    """The join and exchange layer at the port's defaults over the joins
    phase's caches: a shuffled join demoted to broadcast, one that stays
    shuffled, the row probe, the skew split, the hash functions and the
    masked exchange; each query cold and twice warm, checked against
    numpy or the earlier path's answers, with its operators, decisions,
    exchanges, routes and launches."""
    import torch
    t0 = time.perf_counter()
    answers = want
    want = adaptive_reference(table, orders)
    want["q3join"] = jwant["q3join"]
    want["repart_agg"] = answers["repart_agg"]
    host_s = time.perf_counter() - t0
    queries = adaptive_queries(h1, h8)
    emit({"phase": "adaptive.setup", "host_reference_s": host_s})
    seeds = SeedSpy()
    reset_launches()
    spy.take()
    problems = []
    launches_by_query = {}
    try:
        for name, (session, fn) in queries.items():
            before = read_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got, aqe = fn()
            cold = time.perf_counter() - t0
            warm, warm_aqe = [], None
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                _, warm_aqe = fn()
                warm.append(time.perf_counter() - t0)
            if name == "compact_repart":
                want["compact_repart"] = got
            launches = {k: (v - before[k]) // RUNS
                        for k, v in read_launches().items()}
            launches_by_query[name] = launches
            seed_forms = {k: v // RUNS for k, v in seeds.take().items()}
            execs = _exec_names(session)
            bad = validate_adaptive(name, got, want, aqe, warm_aqe,
                                    session.conf)
            if not ADAPTIVE_EXPECT[name] <= set(execs):
                bad.append(f"{name} ran {execs}, expected "
                           f"{sorted(ADAPTIVE_EXPECT[name])}")
            exchanges = _exchange_runs(session)
            if name == "aqe_stays_shuffled" and exchanges != [
                    ("ShuffleExchangeExec", 8, 8, 8, 0)] * 2:
                # each side partitioned once: the measured build exchange
                # is the one the shuffled join reads
                bad.append(f"{name} exchanges {exchanges}")
            if name == "hash_exprs" and seed_forms != {"per_row": 2,
                                                       "scalar": 0}:
                bad.append(f"{name} murmur3 seeds {seed_forms}")
            problems += bad
            emit({"phase": "adaptive.query", "query": name,
                  "correct": not bad, "cold_s": cold, "warm_s": min(warm),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "decisions": aqe, "warm_decisions": warm_aqe,
                  "exchanges": exchanges, "execs": execs,
                  "routes": {k: v // RUNS for k, v in spy.take().items()},
                  "launches": launches, "murmur3_seeds": seed_forms})
    finally:
        seeds.restore()
    hx = launches_by_query["hash_exprs"]["murmur3_int32"]
    if hx != 2:
        problems.append(f"hash_exprs launched B1 {hx} times a run, not 2 "
                        f"(the quantity and the ship date, per-row seeds)")
    if launches_by_query["masked_repart"]["murmur3_int32"] \
            != launches_by_query["compact_repart"]["murmur3_int32"] or \
            launches_by_query["masked_repart"]["murmur3_int32"] <= 0:
        problems.append(f"masked and compact B1 launches differ: "
                        f"{launches_by_query}")
    counts = read_launches()
    emit({"phase": "adaptive", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("adaptive", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 9: window functions
# ---------------------------------------------------------------------------

WIN_ROWS = 10_000_000  # bench.py's WIN_ROWS: q67win runs on this slice


def _runs(*sorted_keys):
    """Boundary flags of sorted key planes, and each row's run start and
    run end (inclusive): np.maximum.accumulate over flagged positions."""
    n = sorted_keys[0].shape[0]
    b = np.zeros(n, bool)
    b[0] = True
    for k in sorted_keys:
        b[1:] |= k[1:] != k[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(b, idx, 0))
    nxt = np.where(b, idx, n)
    end = np.empty(n, np.int64)
    end[:-1] = np.minimum.accumulate(nxt[::-1])[::-1][1:] - 1
    end[-1] = n - 1
    return b, start, end


def _key_order(*fields, stable=False):
    """The row order of a lexicographic sort by non-negative integer
    fields, most significant first: one argsort of the fields packed into
    an int64 (np.lexsort takes about three times as long)."""
    key = np.zeros(fields[0].shape[0], np.int64)
    bits = 0
    for f in fields:
        b = max(1, int(f.max()).bit_length())
        bits += b
        if f.min() < 0 or bits > 63:
            raise AssertionError("sort fields do not pack")
        key = (key << b) | f
    return np.argsort(key, kind="stable" if stable else "quicksort")


def _seg_sum(x, start, upto):
    """Sum of x over [start[i], upto[i]] by one cumsum."""
    cs = np.cumsum(x)
    return cs[upto] - cs[start] + x[start]


def window_reference(t):
    """numpy answers to the window shapes: sorts, boundary flags and
    running maxima (no pandas)."""
    import pyarrow.compute as pc
    ok = t["l_orderkey"].to_numpy()
    ship = t["l_shipdate"].to_numpy().astype(np.int64)
    price = t["l_extendedprice"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    disc = t["l_discount"].to_numpy()
    codes, names = [], []
    for c in ("l_returnflag", "l_linestatus"):
        enc = pc.dictionary_encode(t[c]).combine_chunks()
        codes.append(enc.indices.to_numpy().astype(np.int64))
        names.append(enc.dictionary.to_pylist())
    g = codes[0] * len(names[1]) + codes[1]

    def label(k):
        return (names[0][k // len(names[1])], names[1][k % len(names[1])])
    out = {}
    # q67win: the largest rank per flag pair is 1 + the rows before the
    # pair's last ship date, over the first WIN_ROWS rows
    gw, sw = g[:WIN_ROWS], ship[:WIN_ROWS]
    out["q67win"] = {}
    for k in np.unique(gw):
        d = sw[gw == k]
        out["q67win"][label(k)] = int((d < d.max()).sum()) + 1
    # win_rank_family: flags, ship date descending, order key (the
    # summaries do not depend on the order of tied rows)
    o = _key_order(g, ship.max() - ship, ok)
    gs, ss, ks = g[o], ship[o], ok[o]
    segb, seg_start, seg_end = _runs(gs)
    peerb, peer_start, peer_end = _runs(gs, ss, ks)
    idx = np.arange(len(o))
    size = seg_end - seg_start + 1
    rk = peer_start - seg_start + 1
    cp = np.cumsum(peerb)
    drk = cp - cp[seg_start] + 1
    pos = idx - seg_start
    base, rem = size // 100, size % 100
    cut = (base + 1) * rem
    nt = np.where(pos < cut, pos // np.maximum(base + 1, 1),
                  rem + (pos - cut) // np.maximum(base, 1)) + 1
    pr = np.where(size > 1, (rk - 1) / np.maximum(size - 1, 1), 0.0)
    cd = (peer_end - seg_start + 1) / size
    firsts = np.flatnonzero(segb)
    out["win_rank_family"] = {
        label(gs[f]): v for f, v in zip(firsts, zip(
            np.maximum.reduceat(pos + 1, firsts).tolist(),
            np.maximum.reduceat(rk, firsts).tolist(),
            np.maximum.reduceat(drk, firsts).tolist(),
            np.maximum.reduceat(nt, firsts).tolist(),
            np.add.reduceat(rk, firsts).tolist(),
            np.add.reduceat(pr, firsts).tolist(),
            np.maximum.reduceat(cd, firsts).tolist()))}
    del o, gs, ss, ks, segb, peerb, cp, drk, pos, nt, pr, cd
    # win_running: order key partitions ordered by price (two decimals,
    # so whole cents order it); tied rows keep the input's order, as the
    # port's stable sort does
    o = _key_order(ok, np.rint(price * 100).astype(np.int64), stable=True)
    ks, ps, qs, ds, hs = ok[o], price[o], qty[o], disc[o], ship[o]
    _, seg_start, seg_end = _runs(ks)
    _, _, peer_end = _runs(ks, ps)
    n = len(o)
    idx = np.arange(n)
    rcnt = peer_end - seg_start + 1
    lo, hi = np.maximum(idx - 2, seg_start), np.minimum(idx + 2, seg_end)
    has_lg = idx - 1 >= seg_start
    has_nv = seg_start + 1 <= peer_end
    nxt = np.minimum(idx + 1, n - 1)
    out["win_running"] = {
        "rsum": float(_seg_sum(qs, seg_start, peer_end).sum()),
        "ravg": float((_seg_sum(ds, seg_start, peer_end) / rcnt).sum()),
        "rcnt": int(rcnt.sum()),
        "rmin": float(ps[seg_start].sum()),
        "rmax": float(ps[peer_end].sum()),
        "bsum": float(_seg_sum(qs, lo, hi).sum()),
        "ld": float(np.where(idx + 1 <= seg_end, ds[nxt], 0.0).sum()),
        "lg": float(qs[np.maximum(idx - 1, 0)][has_lg].sum()),
        "fv": int(hs[seg_start].sum()), "lv": int(hs[peer_end].sum()),
        "nv": int(hs[np.minimum(seg_start + 1, n - 1)][has_nv].sum()),
        "n_lg": int(has_lg.sum()), "n_nv": int(has_nv.sum())}
    del o, ks, ps, qs, ds, hs, lo, hi
    # win_shuffled: ship dates ordered by order key
    o = _key_order(ship, ok)
    ss = ship[o]
    segb, seg_start, _ = _runs(ss)
    _, _, peer_end = _runs(ss, ok[o])
    run = _seg_sum(qty[o], seg_start, peer_end)
    firsts = np.flatnonzero(segb)
    out["win_shuffled"] = dict(zip(ss[firsts].tolist(), zip(
        np.add.reduceat(run, firsts).tolist(),
        np.diff(np.append(firsts, len(o))).tolist())))
    del o, ss, run
    # win_global_top: rank over price descending, order key, q < 2
    keep = np.flatnonzero(qty < 2.0)
    o = keep[np.lexsort((ok[keep], -price[keep]))]
    _, peer_start, _ = _runs(price[o], ok[o])
    top = o[peer_start + 1 <= 100]
    out["win_global_top"] = sorted(zip(
        ok[top].tolist(), price[top].tolist(), ship[top].tolist(),
        (peer_start[:len(top)] + 1).tolist()))
    out["dedupe_orders"] = int(np.unique(ok).shape[0])
    return out


def window_queries(w1, w8):
    """name -> (session, run) over bench.py's WIN_ROWS slice cached with
    one partition (w1) and with eight (w8)."""
    H, api = helpers(), port_api()

    def by_flags(df, cols):
        d = df.to_pydict()
        return {(a, b): tuple(d[c][i] for c in cols) if len(cols) > 1
                else d[cols[0]][i]
                for i, (a, b) in enumerate(zip(d["l_returnflag"],
                                               d["l_linestatus"]))}

    def running():
        d = H.win_running(api, w1.li).to_pydict()
        return {k: v[0] for k, v in d.items()}

    def shuffled():
        d = H.win_shuffled(api, w8.li).to_pydict()
        return dict(zip(d["l_shipdate"], zip(d["s"], d["n"])))

    def top():
        d = H.win_global_top(api, w8.li).to_pydict()
        return sorted(zip(d["l_orderkey"], d["l_extendedprice"],
                          d["l_shipdate"], d["rk"]))

    return {
        "q67win": (w1.s, lambda: by_flags(H.q67win(api, w1.li), ["mx"])),
        "win_rank_family": (w1.s, lambda: by_flags(
            H.win_rank_family(api, w1.li),
            ["max_rn", "max_rk", "max_drk", "max_nt", "sum_rk", "sum_pr",
             "max_cd"])),
        "win_running": (w1.s, running),
        "win_shuffled": (w8.s, shuffled),
        "win_global_top": (w8.s, top),
        "dedupe_orders": (w1.s, lambda: H.dedupe_orders(api, w1.li).count()),
    }


def validate_window(name, got, want) -> bool:
    if name in ("q67win", "win_global_top", "dedupe_orders"):
        return got == want
    if set(got) != set(want):
        return False
    if name == "win_rank_family":
        # integers exact, the percent_rank sum to 1e-9, cume_dist's max
        # (a count over a count) exact
        return all(got[k][:5] == want[k][:5]
                   and _close(got[k][5], want[k][5], 1e-9)
                   and got[k][6] == want[k][6] for k in want)
    if name == "win_running":
        return all(got[k] == want[k] if isinstance(want[k], int)
                   else _close(got[k], want[k], 1e-9) for k in want)
    return all(got[k][1] == want[k][1] and _close(got[k][0], want[k][0])
               for k in want)  # win_shuffled


#: what each window query must have run: operators, the window route
WINDOW_EXPECT = {
    "q67win": ({"WindowExec"}, "packed"),
    "win_rank_family": ({"WindowExec"}, "packed"),
    "win_running": ({"WindowExec"}, "general"),
    "win_shuffled": ({"WindowExec", "ShuffleExchangeExec"}, "packed"),
    "win_global_top": ({"WindowExec", "CollectExchangeExec"}, "general"),
    "dedupe_orders": ({"WindowExec"}, "packed"),
}


def _window_child(session) -> str:
    for e in session.last_exec.walk():
        if type(e).__name__ == "WindowExec":
            return type(e.children[0]).__name__
    return ""


def phase_window(table, spy, prof=None):
    """The window queries over bench.py's first WIN_ROWS rows (q67win's
    slice; since the aggtypes phase joined the run, every window query
    runs on it, to keep the script's time)."""
    import torch
    from types import SimpleNamespace

    from spark_rapids_tpu_torch.exec import nodes as X
    t0 = time.perf_counter()
    table = table.slice(0, WIN_ROWS)
    want = window_reference(table)
    host_s = time.perf_counter() - t0
    wspy = RouteSpy(X.WindowExec, ("_packed", "_general"))
    reset_launches()
    spy.take()
    t0 = time.perf_counter()
    s1, s8 = device_session(), device_session()
    w1 = SimpleNamespace(s=s1, li=s1.create_dataframe(table).cache())
    w8 = SimpleNamespace(s=s8, li=s8.create_dataframe(
        table, num_partitions=8).cache())
    counts = [w1.li.count(), w8.li.count()]
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    if counts != [table.num_rows] * 2:
        raise AssertionError(f"window slice cached {counts} rows")
    emit({"phase": "window.setup", "rows": table.num_rows,
          "host_reference_s": host_s, "cache_s": cache_s})
    problems = []
    queries = window_queries(w1, w8)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_window(name, got, want[name])
        routes = {k[1:]: v // RUNS for k, v in wspy.take().items()}
        execs = _exec_names(session)
        e_ops, e_route = WINDOW_EXPECT[name]
        if not good:
            problems.append(f"{name} disagrees with numpy")
        if not e_ops <= set(execs) or set(routes) != {e_route}:
            problems.append(f"{name} ran {execs}, window routes {routes}; "
                            f"expected {WINDOW_EXPECT[name]}")
        below = _window_child(session)
        if name == "win_shuffled" and below != "ShuffleExchangeExec":
            problems.append(f"win_shuffled ran {below} below WindowExec")
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        if name == "win_shuffled" and min(launches["murmur3_int32"],
                                          launches["segsum"]) <= 0:
            problems.append(f"win_shuffled launched {launches}")
        emit({"phase": "window.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm), "launches": launches,
              "window_route": routes, "agg_routes": {
                  k: v // RUNS for k, v in spy.take().items()},
              "execs": execs, "below_window": below,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "window", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("window", {k: v[1] for k, v in queries.items()})
    wspy.restore()
    if problems:
        raise AssertionError("; ".join(problems))
    return counts, w1, want


# ---------------------------------------------------------------------------
# phase 14: the SQL front door and Catalyst plans
# ---------------------------------------------------------------------------

SQL_Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue "
          "FROM lineitem WHERE l_shipdate >= {lo} AND l_shipdate < {hi} "
          "AND l_discount >= 0.05 AND l_discount <= 0.07 "
          "AND l_quantity < 24.0")
SQL_Q1 = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sq, "
          "SUM(l_extendedprice) AS sp, AVG(l_quantity) AS mq, "
          "AVG(l_discount) AS md, COUNT(l_quantity) AS cnt, "
          "MIN(l_discount) AS mind, MAX(l_shipdate) AS maxs FROM lineitem "
          "WHERE l_shipdate <= 10471 GROUP BY l_returnflag, l_linestatus")
SQL_Q72SHFL = ("SELECT COUNT(k) AS n, SUM(s) AS ts, SUM(c) AS tc FROM ("
               "SELECT k, SUM(l_quantity) AS s, COUNT(l_quantity) AS c "
               "FROM (SELECT l_orderkey % 100000 AS k, l_quantity "
               "FROM lineitem) p GROUP BY k) g")
SQL_Q3JOIN = ("SELECT l_orderkey, SUM(l_extendedprice * (1.0 - l_discount)) "
              "AS rev FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
              "WHERE l_shipdate > 9100 AND o_orderdate < 9500 "
              "GROUP BY l_orderkey ORDER BY rev DESC, l_orderkey ASC "
              "LIMIT 10")
SQL_Q67WIN = ("SELECT l_returnflag, l_linestatus, MAX(rk) AS mx FROM ("
              "SELECT l_returnflag, l_linestatus, rank() OVER (PARTITION BY "
              "l_returnflag, l_linestatus ORDER BY l_shipdate) AS rk "
              "FROM lineitem) r GROUP BY l_returnflag, l_linestatus")
SQL_IN = ("SELECT COUNT(*) AS n, SUM(o_custkey) AS cs FROM orders "
          "WHERE o_orderdate >= 9000 AND o_orderdate < 9400 AND o_orderkey "
          "IN (SELECT l_orderkey FROM lineitem WHERE l_shipdate > 9100)")
SQL_NOT_EXISTS = ("SELECT COUNT(*) AS n, SUM(o_custkey) AS cs FROM orders "
                  "WHERE o_orderdate >= 9000 AND o_orderdate < 9400 AND NOT "
                  "EXISTS (SELECT * FROM lineitem WHERE l_orderkey = "
                  "o_orderkey AND l_shipdate > 9100)")
SQL_SCALAR_SUB = ("SELECT COUNT(*) AS n, SUM(l_extendedprice) AS s "
                  "FROM lineitem WHERE l_extendedprice > "
                  "(SELECT AVG(l_extendedprice) FROM lineitem)")
SQL_ROLLUP_CTE = (
    "WITH recent AS (SELECT l_returnflag, l_linestatus, l_quantity, "
    "l_extendedprice FROM lineitem WHERE l_shipdate > 10000) "
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS q, "
    "COUNT(*) AS n FROM recent GROUP BY ROLLUP(l_returnflag, l_linestatus) "
    "UNION ALL SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS q, "
    "COUNT(*) AS n FROM recent WHERE l_extendedprice > 100000.0 "
    "GROUP BY l_returnflag, l_linestatus")
SQL_MATH = ("SELECT l_returnflag, SUM(round(l_extendedprice * l_discount, "
            "2)) AS r, SUM(floor(l_quantity / 7.0)) AS f, "
            "SUM(sqrt(l_extendedprice)) AS s, SUM(pmod(l_orderkey, 97)) AS p, "
            "COUNT(*) AS n FROM lineitem GROUP BY l_returnflag")
#: the Catalyst templates: golden file, column renames to bench.py's,
#: literal values replaced, the columns each scan reads (a Spark plan's
#: scan outputs only the columns its query reads)
CATALYST = {
    "catalyst_q6": ("q6_filter_agg", {}, {"100": str(LO)},
                    {"l_shipdate", "l_quantity", "l_extendedprice",
                     "l_discount"}),
    "catalyst_q3": ("q3_join_agg_topn", {"o_prio": "o_custkey"},
                    {"50": "9100", "150": "9500"},
                    {"l_orderkey", "l_extendedprice", "l_shipdate",
                     "o_orderkey", "o_orderdate"}),
}


def catalyst_plan(name, data_dir) -> str:
    """A golden Catalyst plan of tests/golden_plans/ made to read bench.py's
    lineitem and orders under data_dir: columns renamed, literals moved to
    bench.py's days, each scan's output cut to the columns it reads."""
    golden, renames, literals, keep = CATALYST[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden_plans", golden + ".json")
    with open(path) as f:
        doc = json.loads(f.read().replace("$DATA", data_dir))

    def fix(v):
        if isinstance(v, list):
            return [fix(x) for x in v]
        if not isinstance(v, dict):
            return v
        v = {k: fix(x) for k, x in v.items()}
        cls = str(v.get("class", ""))
        if cls.endswith(".AttributeReference"):
            v["name"] = renames.get(v["name"], v["name"])
        if cls.endswith(".Literal") and v.get("value") in literals:
            v["value"] = literals[v["value"]]
        if cls.endswith(".FileSourceScanExec"):
            v["output"] = [a for a in v["output"] if a[0]["name"] in keep]
        return v
    return json.dumps(fix(doc))


def _flags_first(row):
    """A rollup row's sort key: the flags (a null after every flag), then
    the values."""
    return tuple("~" if v is None else v for v in row[:2]) + tuple(row[2:])


def sql_reference(t, orders, want, jwant, wwant):
    """The answers each SQL query and Catalyst plan is held to: the cached
    path's, the joins path's and the window path's for the shapes they
    share, numpy's for the four new ones and the two Catalyst plans."""
    import pyarrow.compute as pc
    ok = t["l_orderkey"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    price = t["l_extendedprice"].to_numpy()
    disc = t["l_discount"].to_numpy()
    ship = t["l_shipdate"].to_numpy()
    rf = pc.dictionary_encode(t["l_returnflag"]).combine_chunks()
    ls = pc.dictionary_encode(t["l_linestatus"]).combine_chunks()
    rfc, rfn = rf.indices.to_numpy(), rf.dictionary.to_pylist()
    lsc, lsn = ls.indices.to_numpy(), ls.dictionary.to_pylist()
    out = {"sql_q6": want["q6"], "sql_q1": want["q1"],
           "sql_q72shfl": want["q72shfl"], "sql_q3join": jwant["q3join"],
           "sql_q67win": wwant["q67win"], "sql_in_exists": jwant[
               "q4_semi_anti"]}
    avg = price.mean()
    above = price > avg
    out["sql_scalar_sub"] = (int(above.sum()), float(price[above].sum()))

    def groups(mask, keys):
        """(rf, ls) keyed (count, quantity sum) of the masked rows, over
        keys 0 (both flags), 1 (rf only) or 2 (neither)."""
        g = rfc[mask].astype(np.int64) * len(lsn) + lsc[mask]
        n = np.bincount(g, minlength=len(rfn) * len(lsn))
        q = np.bincount(g, weights=qty[mask], minlength=len(n))
        rows = []
        for j in np.nonzero(n)[0]:
            rows.append(((rfn[j // len(lsn)], lsn[j % len(lsn)]),
                         float(q[j]), int(n[j])))
        if keys == 0:
            return rows
        agg = {}
        for (a, b), qq, nn in rows:
            k = (a, None) if keys == 1 else (None, None)
            s = agg.setdefault(k, [0.0, 0])
            s[0] += qq
            s[1] += nn
        return [(k, v[0], v[1]) for k, v in agg.items()]
    recent = ship > 10000
    rows = (groups(recent, 0) + groups(recent, 1) + groups(recent, 2)
            + groups(recent & (price > 100000.0), 0))
    out["sql_rollup_cte"] = sorted(((a, b, q, n) for (a, b), q, n in rows),
                                   key=_flags_first)
    x = price * disc * 100.0
    r = np.sign(x) * np.floor(np.abs(x) + 0.5) * (10.0 ** -2)
    m = {}
    for j, name in enumerate(rfn):
        sel = rfc == j
        m[name] = (float(r[sel].sum()),
                   int(np.floor(qty[sel] / 7.0).astype(np.int64).sum()),
                   float(np.sqrt(price[sel]).sum()),
                   int((ok[sel] % 97).sum()), int(sel.sum()))
    out["sql_math"] = m
    sel = (ship >= LO) & (qty < 24.0)
    out["catalyst_q6"] = float((price[sel] * disc[sel]).sum())
    od_ok = orders["o_orderdate"].to_numpy() < 9500
    keep = (ship > 9100) & od_ok[ok]
    rev = np.bincount(ok[keep], weights=price[keep],
                      minlength=orders.num_rows)
    hit = np.nonzero(np.bincount(ok[keep], minlength=orders.num_rows))[0]
    top = hit[np.lexsort((hit, -rev[hit]))[:10]]
    out["catalyst_q3"] = {int(k): float(rev[k]) for k in top}
    return out


def validate_sql(name, got, want) -> bool:
    if name in ("sql_q6", "sql_q1", "sql_q72shfl"):
        return validate(name[4:], got, want)
    if name in ("sql_q3join", "catalyst_q3"):
        return set(got) == set(want) and all(
            _close(got[k], want[k], 1e-9) for k in want)
    if name == "sql_q67win":
        return validate_window("q67win", got, want)
    if name == "sql_in_exists":
        return got == want
    if name == "sql_scalar_sub":
        return got[0] == want[0] and _close(got[1], want[1], 1e-9)
    if name == "sql_rollup_cte":
        return len(got) == len(want) and all(
            g[:2] == w[:2] and g[3] == w[3] and _close(g[2], w[2])
            for g, w in zip(got, want))
    if name == "sql_math":
        return set(got) == set(want) and all(
            _close(got[k][0], want[k][0], 1e-9) and got[k][1] == want[k][1]
            and _close(got[k][2], want[k][2], 1e-9)
            and got[k][3:] == want[k][3:] for k in want)
    return _close(got, want, 1e-9)  # catalyst_q6


def sql_queries(s1, s8, sw, sp, data_dir):
    """name -> (session, SQL text or Catalyst plan, the DataFrame query of
    the same name, the reading of a result): s1 holds the joins path's
    1-partition caches as the views lineitem and orders, s8 its
    8-partition ones (joins shuffle there), sw the window path's slice as
    lineitem, sp reads the Parquet files."""
    from spark_rapids_tpu_torch.plan.catalyst import ingest_catalyst
    H, api = helpers(), port_api()
    col, lit, F = api.col, api.lit, api.F
    li, od, wli = s1.table("lineitem"), s1.table("orders"), sw.table(
        "lineitem")
    li8, od8 = s8.table("lineitem"), s8.table("orders")

    def one(df):
        return list(df.to_pydict().values())[0][0]

    def q1_read(df):
        d = df.to_pydict()
        return {(a, b): (sq, sp_, mq, md, c) for a, b, sq, sp_, mq, md, c in
                zip(d["l_returnflag"], d["l_linestatus"], d["sq"], d["sp"],
                    d["mq"], d["md"], d["cnt"])}

    def q72_read(df):
        d = df.to_pydict()
        return (int(d["n"][0]), round(float(d["ts"][0]), 2), int(d["tc"][0]))

    def top_read(key, value):
        def read(df):
            d = df.to_pydict()
            return dict(zip(d[key], d[value]))
        return read

    def win_read(df):
        d = df.to_pydict()
        return dict(zip(zip(d["l_returnflag"], d["l_linestatus"]), d["mx"]))

    def q4_read(dfs):
        out = {}
        for how, df in zip(("left_semi", "left_anti"), dfs):
            d = df.to_pydict()
            out[how] = (d["n"][0], d["cs"][0])
        return out

    def scalar_read(df):
        d = df.to_pydict()
        return (int(d["n"][0]), float(d["s"][0]))

    def rollup_read(df):
        d = df.to_pydict()
        return sorted(zip(d["l_returnflag"], d["l_linestatus"], d["q"],
                          d["n"]), key=_flags_first)

    def math_read(df):
        d = df.to_pydict()
        return {k: (r, f, s_, p, n) for k, r, f, s_, p, n in zip(
            d["l_returnflag"], d["r"], d["f"], d["s"], d["p"], d["n"])}

    def scalar_df():
        avg = one(li.agg(F.avg(col("l_extendedprice"))))
        return li.filter(col("l_extendedprice") > lit(avg)).agg(
            F.count().alias("n"), F.sum(col("l_extendedprice")).alias("s"))

    def rollup_df():
        recent = li.filter(col("l_shipdate") > lit(10000)).select(
            col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
            col("l_extendedprice"))
        aggs = (F.sum(col("l_quantity")).alias("q"), F.count().alias("n"))
        return recent.rollup("l_returnflag", "l_linestatus").agg(*aggs) \
            .union(recent.filter(col("l_extendedprice") > lit(100000.0))
                   .group_by("l_returnflag", "l_linestatus").agg(*aggs))

    def math_df():
        return li.group_by("l_returnflag").agg(
            F.sum(F.round(col("l_extendedprice") * col("l_discount"), 2))
            .alias("r"),
            F.sum(F.floor(col("l_quantity") / lit(7.0))).alias("f"),
            F.sum(F.sqrt(col("l_extendedprice"))).alias("s"),
            F.sum(F.pmod(col("l_orderkey"), lit(97))).alias("p"),
            F.count().alias("n"))

    def pq_scan(name, cols):
        return sp.read_parquet(os.path.join(data_dir, name), columns=cols)

    def q3_catalyst_df():
        lip = pq_scan("lineitem.parquet", ["l_orderkey", "l_extendedprice",
                                           "l_shipdate"])
        odp = pq_scan("orders.parquet", ["o_orderkey", "o_orderdate"])
        j = lip.filter(col("l_shipdate") > lit(9100)).join(
            odp.filter(col("o_orderdate") < lit(9500)),
            on=[(col("l_orderkey"), col("o_orderkey"))])
        return j.group_by(col("l_orderkey")).agg(
            F.sum(col("l_extendedprice")).alias("rev")).order_by(
            col("rev").desc(), col("l_orderkey").asc()).limit(10)

    def q6_catalyst_df():
        return pq_scan("lineitem.parquet", Q6_COLS).filter(
            (col("l_shipdate") >= lit(LO)) & (col("l_quantity") < lit(24.0))
        ).agg(F.sum(col("l_extendedprice") * col("l_discount"))
              .alias("revenue"))

    def catalyst(name):
        text = catalyst_plan(name, data_dir)
        return lambda session: ingest_catalyst(text, session)

    def sql(*texts):
        if len(texts) == 1:
            return lambda session: session.sql(texts[0])
        return lambda session: [session.sql(t) for t in texts]

    q72_df = H.q72shfl(api, li).agg(F.count(col("k")).alias("n"),
                                    F.sum(col("s")).alias("ts"),
                                    F.sum(col("c")).alias("tc"))
    return {
        "sql_q6": (s1, sql(SQL_Q6.format(lo=LO, hi=HI)),
                   lambda: H.q6(api, li), one),
        "sql_q1": (s1, sql(SQL_Q1), lambda: H.q1(api, li), q1_read),
        "sql_q72shfl": (s1, sql(SQL_Q72SHFL), lambda: q72_df, q72_read),
        "sql_q3join": (s1, sql(SQL_Q3JOIN), lambda: H.q3join(api, li, od),
                       top_read("l_orderkey", "rev")),
        "sql_q67win": (sw, sql(SQL_Q67WIN), lambda: H.q67win(api, wli),
                       win_read),
        "sql_in_exists": (s8, sql(SQL_IN, SQL_NOT_EXISTS), lambda: [
            H.q4_semi_anti(api, li8, od8, how)
            for how in ("left_semi", "left_anti")], q4_read),
        "sql_scalar_sub": (s1, sql(SQL_SCALAR_SUB), scalar_df, scalar_read),
        "sql_rollup_cte": (s1, sql(SQL_ROLLUP_CTE), rollup_df, rollup_read),
        "sql_math": (s1, sql(SQL_MATH), math_df, math_read),
        "catalyst_q6": (sp, catalyst("catalyst_q6"), q6_catalyst_df, one),
        "catalyst_q3": (sp, catalyst("catalyst_q3"), q3_catalyst_df,
                        top_read("l_orderkey", "rev")),
    }


def _plan_reading(session, spy, before):
    """(operators in walk order, routes, launches) of the session's last
    run since ``before`` (launch counts)."""
    return ([type(e).__name__ for e in session.last_exec.walk()],
            spy.take(), {k: v - before[k]
                         for k, v in read_launches().items()})


def _plan_difference(sql, df):
    """How a SQL query's reading differs from its DataFrame query's: the
    operators one has more of than the other, and whether the routes and
    the launches differ."""
    from collections import Counter
    a, b = Counter(sql[0]), Counter(df[0])
    return {"sql_only_execs": dict(a - b), "dataframe_only_execs": dict(b - a),
            "routes_differ": sql[1] != df[1],
            "launches_differ": sql[2] != df[2]}


def _collect_all(dfs):
    return [df.collect() for df in dfs] if isinstance(dfs, list) \
        else dfs.collect()


def phase_sql(table, orders, want, jwant, wwant, h1, h8, w1, tmp_dir, spy,
              prof=None):
    """session.sql over the joins path's caches and the window path's
    slice registered as temp views, and two Catalyst plans over the
    Parquet files in tmp_dir; each query's operators, routes and launches
    held beside those of the DataFrame query of the same name."""
    import pyarrow.parquet as pq
    import torch
    t0 = time.perf_counter()
    sub = sql_reference(table, orders, want, jwant, wwant)
    pq.write_table(orders, os.path.join(tmp_dir, "orders.parquet"),
                   row_group_size=1 << 20, use_dictionary=["o_orderdate"],
                   compression="snappy", data_page_version="1.0")
    host_s = time.perf_counter() - t0
    for h in (h1, h8):
        h.s.create_or_replace_temp_view("lineitem", h.li)
        h.s.createOrReplaceTempView("orders", h.od)
    w1.s.create_or_replace_temp_view("lineitem", w1.li)
    sp = device_session()
    queries = sql_queries(h1.s, h8.s, w1.s, sp, tmp_dir)
    emit({"phase": "sql.setup", "host_reference_s": host_s})
    reset_launches()
    spy.take()
    problems = []
    for name, (session, parse, df_query, read) in queries.items():
        # the DataFrame query of the same name, once, for its plan
        before = read_launches()
        _collect_all(df_query())
        df_plan = _plan_reading(session, spy, before)
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dfs = parse(session)  # a scalar subquery runs here, on the card
        torch.cuda.synchronize()
        parse_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = read(_collect_all(dfs))
        cold_ms = (time.perf_counter() - t0) * 1e3
        plan = _plan_reading(session, spy, before)
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            _collect_all(dfs)
            warm.append((time.perf_counter() - t0) * 1e3)
        spy.take()
        good = validate_sql(name, got, sub[name])
        if not good:
            problems.append(f"{name} disagrees with its answer")
        same = plan == df_plan
        line = {"phase": "sql.query", "query": name, "correct": good,
                "parse_ms": parse_ms, "cold_ms": cold_ms,
                "warm_ms": min(warm),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "routes": plan[1], "launches": plan[2], "execs": plan[0],
                "same_plan_as_dataframe": same}
        if not same:
            line["dataframe"] = {"execs": df_plan[0], "routes": df_plan[1],
                                 "launches": df_plan[2]}
            line["differs_in"] = _plan_difference(plan, df_plan)
        emit(line)
    counts = read_launches()
    emit({"phase": "sql", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("sql", {k: (lambda v=v: _collect_all(v[1](v[0])))
                         for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    # B2 in the SQL aggregates, B3 under the Catalyst plans' scans; the
    # path's one shuffle hashes int64 order keys, which B1 (int32 planes)
    # does not take, in either package
    if min(counts[k] for k in ("segsum", "bitslice")) <= 0:
        raise AssertionError(f"a kernel did not run on the SQL path: "
                             f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 10: CASE/IN and the other expressions, and the new aggregates
# ---------------------------------------------------------------------------

def exprs_reference(t):
    """numpy answers to the expression and aggregate shapes: bincounts,
    two sorts of packed keys (group, value, row index), and the row
    query's columns."""
    import pyarrow.compute as pc
    okey = t["l_orderkey"].to_numpy()
    ship = t["l_shipdate"].to_numpy().astype(np.int64)
    price = t["l_extendedprice"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    disc = t["l_discount"].to_numpy()
    n = okey.shape[0]
    idx = np.arange(n, dtype=np.int64)
    codes, names = [], []
    for c in ("l_returnflag", "l_linestatus"):
        enc = pc.dictionary_encode(t[c]).combine_chunks()
        codes.append(enc.indices.to_numpy().astype(np.int64))
        names.append(enc.dictionary.to_pylist())
    rf, ls = codes
    out = {}

    lo = int(ship.min())
    day = ship - lo
    rev = price * (1.0 - disc)
    ar = (rf == names[0].index("A")) | (rf == names[0].index("R"))
    cnt = np.bincount(day)
    promo = np.bincount(day, weights=np.where(ar, rev, 0.0))
    tot = np.bincount(day, weights=rev)
    out["q14_case"] = {int(d) + lo: (promo[d], tot[d], int(cnt[d]))
                       for d in np.nonzero(cnt)[0]}

    def moments(g, x, ngroups, ddof):
        c = np.bincount(g, minlength=ngroups)
        mean = np.bincount(g, weights=x, minlength=ngroups) / np.maximum(c, 1)
        dev = x - mean[g]
        m2 = np.bincount(g, weights=dev * dev, minlength=ngroups)
        return c, m2 / np.maximum(c - ddof, 1)

    keep = ship <= 10471
    g = (rf * len(names[1]) + ls)[keep]
    ng = len(names[0]) * len(names[1])
    c, var_q = moments(g, qty[keep], ng, 1)
    _, vp_p = moments(g, price[keep], ng, 0)
    avg = np.bincount(g, weights=disc[keep], minlength=ng) / np.maximum(c, 1)
    first = np.full(ng, -1)
    last = np.full(ng, -1)
    pos = np.arange(g.shape[0])
    first[g[::-1]] = pos[::-1]  # the last write, the smallest position
    last[g] = pos
    ship_k, disc_k = ship[keep], disc[keep]
    out["q1_stats"] = {
        (names[0][k // len(names[1])], names[1][k % len(names[1])]): (
            np.sqrt(var_q[k]), vp_p[k], int(ship_k[first[k]]),
            disc_k[last[k]], avg[k], int(c[k]))
        for k in range(ng) if c[k]}

    k = okey % 100_000
    c, var_p = moments(k, price, 100_000, 1)
    _, var_d = moments(k, disc, 100_000, 1)
    first = np.full(100_000, -1)
    first[k[::-1]] = idx[::-1]
    out["stats_by_order"] = {
        int(j): (np.sqrt(var_p[j]) if c[j] > 1 else None,
                 var_d[j] if c[j] > 1 else None, qty[first[j]])
        for j in np.nonzero(c)[0]}

    def sorted_by_day(cents, bits):
        # (day, value, row index) packed and sorted: values ascending
        # within a day, ties in row order
        key = np.sort((day << (bits + 25)) | (cents << 25) | idx)
        return key, key >> 25, key & ((1 << 25) - 1)

    def interpolate(vals_sorted, starts, m, p):
        rank = p * np.maximum(m - 1, 0).astype(np.float64)
        r_lo = np.floor(rank).astype(np.int64)
        r_hi = np.ceil(rank).astype(np.int64)
        frac = rank - r_lo
        v_lo = vals_sorted[starts + r_lo]
        v_hi = vals_sorted[starts + r_hi]
        return v_lo + (v_hi - v_lo) * frac

    m = cnt[cnt > 0]
    days = np.nonzero(cnt)[0]
    starts = np.concatenate([[0], np.cumsum(m)[:-1]])
    pkey, pdv, prow = sorted_by_day(np.rint(price * 100).astype(np.int64), 24)
    p50 = interpolate(price[prow], starts, m, 0.5)
    # max_by: the first row of the day's last run of equal prices
    top_row = prow[np.searchsorted(pkey >> 25, pdv[starts + m - 1])]
    dkey, _, drow = sorted_by_day(np.rint(disc * 100).astype(np.int64), 4)
    p90 = interpolate(disc[drow], starts, m, 0.9)
    out["pctl_shuffled"] = {
        int(d) + lo: (p50[i], p90[i], int(okey[top_row[i]]),
                      int(okey[drow[starts[i]]]))
        for i, d in enumerate(days)}

    sel = np.nonzero(ship < 8500)[0]
    # the 8-partition cache splits the rows into contiguous slices, the
    # first n % 8 one row longer
    bounds = np.cumsum([n // 8 + (i < n % 8) for i in range(8)])
    pid = np.searchsorted(bounds, sel, side="right")
    first_of_pid = np.searchsorted(pid, np.arange(8))
    rank = np.arange(sel.shape[0]) - first_of_pid[pid]
    q, v = qty[sel], price[sel] * 1e14
    status = np.array(["returned", names[1][0], names[1][1], "none"],
                      dtype=object)
    code = np.where(rf[sel] == names[0].index("R"), 0,
                    np.where(rf[sel] == names[0].index("A"),
                             1 + ls[sel], 3))
    offs = price[sel] * disc[sel]
    out["cleanse_rows"] = {
        "l_orderkey": okey[sel], "status": status[code].tolist(),
        "ok7": okey[sel] // 7, "nq": (q, q == 1.0),
        "nvl_q": np.where(q == 1.0, 0.0, q),
        "hi": np.maximum(offs, q * 100.0), "lo": np.minimum(offs, q * 100.0),
        "ts": ship[sel] * 86_400_000_000, "ts_s": ship[sel] * 86_400,
        "sat": np.where(v >= 2.0 ** 63, (1 << 63) - 1, np.trunc(
            np.where(v >= 2.0 ** 63, 0.0, v)).astype(np.int64)),
        "ns": (q != 1.0) & (q == 50.0), "pid": pid,
        "mid": (pid.astype(np.int64) << 33) + rank}
    return out


def exprs_queries(h1, h8):
    """name -> (session, run) over the joins phase's caches; each run
    collects a pyarrow table."""
    H, api = helpers(), port_api()
    return {
        "q14_case": (h1.s, lambda: H.q14_case(api, h1.li).collect()),
        "q1_stats": (h1.s, lambda: H.q1_stats(api, h1.li).collect()),
        "stats_by_order": (h1.s,
                           lambda: H.stats_by_order(api, h1.li).collect()),
        "pctl_shuffled": (h8.s, lambda: H.pctl_shuffled(api, h8.li).collect()),
        "cleanse_rows": (h8.s, lambda: H.cleanse_rows(api, h8.li).collect()),
    }


#: per aggregate query: its key columns and the columns validate_exprs reads
EXPRS_COLUMNS = {
    "q14_case": ("l_shipdate", ["promo", "rev", "n"]),
    "q1_stats": (("l_returnflag", "l_linestatus"),
                 ["sd_q", "vp_p", "first_ship", "last_disc", "avg_abs", "n"]),
    "stats_by_order": ("k", ["sd_p", "var_d", "first_q"]),
    "pctl_shuffled": ("l_shipdate", ["p50", "p90", "top", "cheap"]),
}


def _by_key(table, key, cols):
    d = table.to_pydict()
    keys = list(zip(*[d[k] for k in key])) if isinstance(key, tuple) \
        else d[key]
    return {k: tuple(d[c][i] for c in cols) for i, k in enumerate(keys)}


def _same_floats(got, want, tol):
    return all(g is None and w is None or (g is not None and w is not None
                                           and _close(g, w, tol))
               for g, w in zip(got, want))


def validate_exprs(name, got, want) -> bool:
    if name == "cleanse_rows":
        import pyarrow as pa
        if got.num_rows != want["l_orderkey"].shape[0]:
            return False
        for c in got.column_names:
            col = got[c].combine_chunks()
            if c == "status":
                ok = col.to_pylist() == want[c]
            elif c == "nq":
                vals, null = want[c]
                ok = (np.array_equal(col.is_null().to_numpy(
                    zero_copy_only=False), null) and np.array_equal(
                    col.fill_null(0.0).to_numpy()[~null], vals[~null]))
            else:
                if pa.types.is_timestamp(col.type):
                    col = col.cast(pa.int64())
                ok = col.null_count == 0 and np.array_equal(
                    col.to_numpy(zero_copy_only=False), want[c])
            if not ok:
                return False
        return True
    got = _by_key(got, *EXPRS_COLUMNS[name])
    if set(got) != set(want):
        return False
    if name == "q14_case":
        return all(_same_floats(got[k][:2], want[k][:2], 1e-9)
                   and got[k][2] == want[k][2] for k in want)
    if name == "q1_stats":
        return all(_same_floats(got[k][:2], want[k][:2], 1e-9)
                   and got[k][2:4] == want[k][2:4]
                   and _close(got[k][4], want[k][4], 1e-9)
                   and got[k][5] == want[k][5] for k in want)
    if name == "stats_by_order":
        return all(_same_floats(got[k][:2], want[k][:2], 1e-9)
                   and got[k][2] == want[k][2] for k in want)
    return all(got[k] == want[k] for k in want)  # pctl_shuffled, exactly


#: what each query must have run: operators, and the aggregate routes per
#: run (exactly)
EXPRS_EXPECT = {
    "q14_case": ({"HashAggregateExec", "CachedScanExec"},
                 {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
                  "_scatter_agg": 1}),
    "q1_stats": ({"HashAggregateExec"}, {"_bucket_update": 1}),
    "stats_by_order": ({"HashAggregateExec"}, {"_scatter_agg": 1}),
    "pctl_shuffled": ({"HashAggregateExec", "ShuffleExchangeExec"},
                      {"_sort_agg": 8}),
    "cleanse_rows": ({"ProjectExec", "FilterExec"}, {}),
}
#: kernel launches per run: B2 in q14_case's four chunks, B1 once per
#: cached partition batch into pctl_shuffled's exchange, nothing elsewhere
EXPRS_LAUNCHES = {"q14_case": {"segsum": 4}, "pctl_shuffled":
                  {"murmur3_int32": 8}}


def phase_exprs(table, h1, h8, spy, prof=None):
    import torch
    t0 = time.perf_counter()
    want = exprs_reference(table)
    host_s = time.perf_counter() - t0
    emit({"phase": "exprs.setup", "rows": table.num_rows,
          "host_reference_s": host_s})
    reset_launches()
    spy.take()
    problems = []
    # the runtime phase's task wave checks pctl_shuffled against it
    RUN_NOTES["pctl_shuffled_want"] = want["pctl_shuffled"]
    queries = exprs_queries(h1, h8)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_exprs(name, got, want[name])
        counts = spy.take()
        routes = {k: v // RUNS for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        e_ops, e_routes = EXPRS_EXPECT[name]
        e_launch = {k: EXPRS_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not good:
            problems.append(f"{name} disagrees with numpy")
        if not e_ops <= set(execs) or routes != e_routes \
                or any(v % RUNS for v in counts.values()):
            problems.append(f"{name} ran {execs}, routes {routes}; "
                            f"expected {EXPRS_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "exprs.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm), "launches": launches,
              "routes": routes, "execs": execs,
              "result_rows": got.num_rows,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "exprs", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("exprs", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 11: unions, grouping sets, ranges and the DataFrame surface
# ---------------------------------------------------------------------------

def _codes(col):
    """pyarrow dictionary codes (int64) and the vocabulary of a column."""
    import pyarrow.compute as pc
    enc = pc.dictionary_encode(col).combine_chunks()
    return enc.indices.to_numpy().astype(np.int64), enc.dictionary.to_pylist()


def sets_reference(t, orders):
    """numpy answers to the set shapes: bincounts per grouping set, the
    set operations by masks over the unique order keys, range_agg's closed
    form, the summary statistics, and the splitmix64 stream."""
    H = helpers()
    ship = t["l_shipdate"].to_numpy().astype(np.int64)
    price = t["l_extendedprice"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    disc = t["l_discount"].to_numpy()
    rf, rfv = _codes(t["l_returnflag"])
    ls, lsv = _codes(t["l_linestatus"])
    out = {}

    def per_set(keep, rows, cols, n_ls=len(lsv)):
        """{(rf or None, ls or None): sums of cols and the count} over the
        (rf, ls), (rf), (ls) and () sets named in rows."""
        g = (rf * n_ls + ls)[keep]
        ng = len(rfv) * n_ls
        sums = [np.bincount(g, weights=c[keep], minlength=ng) for c in cols]
        cnt = np.bincount(g, minlength=ng)
        res = {}
        for k in range(ng):
            a, b = k // n_ls, k % n_ls
            for key, pick in (("rl", (rfv[a], lsv[b])), ("r", (rfv[a], None)),
                              ("l", (None, lsv[b])), ("", (None, None))):
                if key not in rows:
                    continue
                acc = res.setdefault(pick, [0.0] * len(cols) + [0])
                for j, s in enumerate(sums):
                    acc[j] += s[k]
                acc[-1] += int(cnt[k])
        return {k: v for k, v in res.items() if v[-1]}

    keep = ship <= 10471
    q1 = per_set(keep, ("rl", "r", ""), [qty, price, disc])
    gid = {(True, True): 0, (True, False): 1, (False, False): 3}
    out["q1_rollup"] = {
        (a, b, gid[(a is not None, b is not None)]):
            (v[0], v[1], v[2] / v[3], v[3]) for (a, b), v in q1.items()}
    cube = per_set(np.ones(ship.shape[0], bool), ("rl", "r", "l", ""), [qty])
    out["cube_flags"] = {(a, b, int(a is None), int(b is None)): (v[0], v[1])
                         for (a, b), v in cube.items()}
    piv = per_set(np.ones(ship.shape[0], bool), ("rl",), [price])
    out["pivot_flags"] = {
        b: tuple(x for a in sorted(rfv) for x in (
            piv[(a, b)][0] if (a, b) in piv else None,
            piv[(a, b)][1] if (a, b) in piv else None))
        for b in lsv}

    year, week = ship // 365, ship // 7
    rev = price * (1.0 - disc)
    y0, w0 = int(year.min()), int(week.min())
    ny, nw = int(year.max()) - y0 + 1, int(week.max()) - w0 + 1
    yw = (year - y0) * nw + (week - w0)
    s_yw = np.bincount(yw, weights=rev, minlength=ny * nw)
    c_yw = np.bincount(yw, minlength=ny * nw)
    roll = {}
    for k in np.nonzero(c_yw)[0]:
        y, w = int(k // nw) + y0, int(k % nw) + w0
        for key in ((y, w), (y, None), (None, None)):
            acc = roll.setdefault(key, [0.0, 0])
            acc[0] += s_yw[k]
            acc[1] += int(c_yw[k])
    out["rollup_shipdate"] = {k: tuple(v) for k, v in roll.items()}

    lo = int(ship.min())
    cnt = np.bincount(ship - lo)
    qsum = np.bincount(ship - lo, weights=qty)
    out["union_repart"] = {int(d) + lo: (float(qsum[d]), int(cnt[d]))
                           for d in np.nonzero(cnt)[0]}

    ok = orders["o_orderkey"].to_numpy()
    ck = orders["o_custkey"].to_numpy()
    early = orders["o_orderdate"].to_numpy() < 9500
    third = ck % 3 == 0
    out["orders_setops"] = [
        (op, int(m.sum()), int(ok[m].sum()), int(ck[m].sum()))
        for op, m in (("intersect", early & third),
                      ("except", early & ~third))]

    k, sums, counts = H.range_agg_answer()
    out["range_agg"] = {int(a): (int(b), int(c))
                        for a, b, c in zip(k, sums, counts)}

    stats = {}
    for c in H.DESCRIBE_COLS:
        x = t[c].to_numpy()
        stats[c] = (x.shape[0], x.mean(), x.std(ddof=1), x.min(), x.max())
    out["describe_li"] = (stats, float(np.corrcoef(qty, price)[0, 1]))

    keep = H.splitmix_rand(ship.shape[0], 11) < 0.01
    out["sample_li"] = (int(keep.sum()),
                        int(t["l_orderkey"].to_numpy()[keep].sum()))
    return out


def sets_queries(h1, h8):
    """name -> (session, run) over the joins phase's caches; each run
    returns what validate_sets reads."""
    H, api = helpers(), port_api()

    def rows(df, keys, cols):
        d = df.collect().to_pydict()
        return {tuple(d[k][i] for k in keys): tuple(d[c][i] for c in cols)
                for i in range(len(d[keys[0]]))}

    def describe():
        table, corr = H.describe_li(api, h1.li)
        return table.to_pydict(), corr

    return {
        "q1_rollup": (h1.s, lambda: rows(
            H.q1_rollup(api, h1.li), ("l_returnflag", "l_linestatus", "gid"),
            ("sum_qty", "sum_price", "avg_disc", "n"))),
        "rollup_shipdate": (h1.s, lambda: rows(
            H.rollup_shipdate(api, h1.li), ("ship_year", "ship_week"),
            ("rev", "n"))),
        "cube_flags": (h1.s, lambda: rows(
            H.cube_flags(api, h1.li),
            ("l_returnflag", "l_linestatus", "g_rf", "g_ls"),
            ("sum_qty", "n"))),
        "union_repart": (h8.s, lambda: {
            k[0]: v for k, v in rows(H.union_repart(api, h8.li, h1.li),
                                     ("l_shipdate",),
                                     ("sum_qty", "n")).items()}),
        "orders_setops": (h8.s, lambda: [
            tuple(r.values()) for r in
            H.orders_setops(api, h8.od).collect().to_pylist()]),
        "range_agg": (h8.s, lambda: {
            k[0]: v for k, v in rows(H.range_agg(api, h8.s), ("k",),
                                     ("s", "n")).items()}),
        "pivot_flags": (h1.s, lambda: {
            k[0]: v for k, v in rows(
                H.pivot_flags(api, h1.li), ("l_linestatus",),
                ("A_price", "A_n", "N_price", "N_n", "R_price",
                 "R_n")).items()}),
        "describe_li": (h1.s, describe),
        "sample_li": (h1.s, lambda: tuple(
            H.sample_li(api, h1.li).collect().to_pylist()[0].values())),
    }


def _floats_close(got, want, tol=1e-6):
    return all((g is None) == (w is None)
               and (g is None or _close(g, w, tol))
               for g, w in zip(got, want))


def validate_sets(name, got, want) -> bool:
    if name in ("orders_setops", "range_agg", "union_repart", "sample_li"):
        # integer sums, and union_repart's sums of whole quantities,
        # are exact
        return got == want
    if name == "describe_li":
        table, corr = got
        stats, want_corr = want
        if table["summary"] != ["count", "mean", "stddev", "min", "max"]:
            return False
        for c, (n, mean, sd, lo, hi) in stats.items():
            cells = table[c]
            if int(cells[0]) != n or float(cells[3]) != lo \
                    or float(cells[4]) != hi:
                return False
            if not (_close(float(cells[1]), mean, 1e-9)
                    and _close(float(cells[2]), sd, 1e-9)):
                return False
        return _close(corr, want_corr, 1e-9)
    if set(got) != set(want):
        return False
    if name == "pivot_flags":
        return all(_floats_close(got[k][0::2], want[k][0::2])
                   and got[k][1::2] == want[k][1::2] for k in want)
    # the grouping-set shapes: float sums to 1e-6, counts exactly
    return all(_floats_close(got[k][:-1], want[k][:-1])
               and got[k][-1] == want[k][-1] for k in want)


#: what each set query must have run: operators, the aggregate routes per
#: run (exactly), and the form of its Expand (stacked or not)
SETS_EXPECT = {
    "q1_rollup": ({"ExpandExec", "FilterExec"},
                  {"_scatter_agg": 1, "_sort_agg": 3}, False),
    "rollup_shipdate": ({"ExpandExec"},
                        {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 12,
                         "_scatter_agg": 9}, True),
    "cube_flags": ({"ExpandExec"}, {"_scatter_agg": 1, "_sort_agg": 4},
                   False),
    "union_repart": ({"UnionExec", "ShuffleExchangeExec"},
                     {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
                      "_scatter_agg": 1}, None),
    "orders_setops": ({"UnionExec", "BroadcastHashJoinExec"},
                      {"_packed_sort_agg": 2, "_global_update": 2}, None),
    # the JAX package's plan for 2^28 estimated rows: partial per range
    # batch (32 a partition), a merge per partition, collect, final
    "range_agg": ({"RangeExec", "CollectExchangeExec"}, {"_scatter_agg": 265},
                  None),
    "pivot_flags": ({"HashAggregateExec"}, {"_bucket_update": 2}, None),
    "describe_li": ({"HashAggregateExec"}, {"_global_update": 2}, None),
    "sample_li": ({"FilterExec"}, {"_global_update": 1}, None),
}
#: kernel launches per run: B2 in rollup_shipdate's twelve chunks and
#: union_repart's four, B1 once per union batch into union_repart's
#: exchange
SETS_LAUNCHES = {"rollup_shipdate": {"segsum": 12},
                 "union_repart": {"segsum": 4, "murmur3_int32": 9}}


def _expand_forms(session):
    return [e.stacked for e in session.last_exec.walk()
            if type(e).__name__ == "ExpandExec"]


def phase_sets(table, orders, h1, h8, spy, prof=None):
    import torch
    t0 = time.perf_counter()
    want = sets_reference(table, orders)
    RUN_NOTES["q1_rollup_want"] = want["q1_rollup"]  # the obs phase's
    host_s = time.perf_counter() - t0
    emit({"phase": "sets.setup", "rows": table.num_rows,
          "orders_rows": orders.num_rows, "host_reference_s": host_s})
    reset_launches()
    spy.take()
    problems = []
    queries = sets_queries(h1, h8)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        forms = _expand_forms(session)
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_sets(name, got, want[name])
        counts = spy.take()
        routes = {k: v // RUNS for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        e_ops, e_routes, e_stacked = SETS_EXPECT[name]
        e_launch = {k: SETS_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not good:
            problems.append(f"{name} disagrees with numpy")
        if not e_ops <= set(execs) or routes != e_routes \
                or any(v % RUNS for v in counts.values()) \
                or forms != ([] if e_stacked is None else [e_stacked]):
            problems.append(f"{name} ran {execs}, routes {routes}, stacked "
                            f"expands {forms}; expected {SETS_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "sets.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm), "launches": launches,
              "routes": routes, "execs": execs, "stacked_expand": forms,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "sets", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("sets", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if min(counts["murmur3_int32"], counts["segsum"]) <= 0:
        raise AssertionError(f"a kernel did not run on the sets path: "
                             f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the aggregate types (partial -> collect -> final, DECIMAL64,
# arrays from collect_list/collect_set)
# ---------------------------------------------------------------------------

def aggtypes_reference(t, want):
    """numpy answers to the aggregate-type shapes, from the float lineitem:
    decimal sums as integer cents (exact: every partial sum stays below
    2^53), FLOAT64 results as floats, and per order the ship dates in
    input order (a stable argsort by key) and the set of return flags as
    a bit mask."""
    H = helpers()
    cents = {c: np.round(t[c].to_numpy() * 100).astype(np.int64)
             for c in H.DEC_COLS}
    price = t["l_extendedprice"].to_numpy()
    disc = t["l_discount"].to_numpy()
    ship = t["l_shipdate"].to_numpy()
    rf, rfv = _codes(t["l_returnflag"])
    ls, lsv = _codes(t["l_linestatus"])
    out = {"q72shfl_x3": {k: (3 * s, 3 * c)
                          for k, (s, c) in want["q72shfl_groups"].items()}}
    keep = (ship >= LO) & (ship < HI) & (cents["l_discount"] >= 5) \
        & (cents["l_discount"] <= 7) & (cents["l_quantity"] < 2400)
    out["q6_dec"] = float(np.sum(price[keep] * disc[keep]))
    keep = ship <= 10471
    ng = len(rfv) * len(lsv)
    g = (rf * len(lsv) + ls)[keep]

    def per_group(x):
        return np.bincount(g, weights=x[keep], minlength=ng)
    n = np.bincount(g, minlength=ng)
    sq, sp, sd = (per_group(cents[c].astype(np.float64)) for c in H.DEC_COLS)
    sdp = per_group(price * (1.0 - disc))
    order = np.argsort(g.astype(np.uint8), kind="stable")  # a radix sort
    starts = np.searchsorted(g[order], np.arange(ng))
    present = n > 0
    mind = np.minimum.reduceat(cents["l_discount"][keep][order],
                               starts[present])
    maxp = np.maximum.reduceat(cents["l_extendedprice"][keep][order],
                               starts[present])
    out["q1_dec"] = {
        (rfv[k // len(lsv)], lsv[k % len(lsv)]): (
            int(sq[k]), int(sp[k]), float(sdp[k]), sq[k] / n[k] / 100,
            sd[k] / n[k] / 100, int(n[k]), int(lo), int(hi))
        for k, lo, hi in zip(np.nonzero(present)[0], mind, maxp)}
    dk = cents["l_discount"]
    n = np.bincount(dk)
    sq = np.bincount(dk, weights=cents["l_quantity"].astype(np.float64))
    sp = np.bincount(dk, weights=price)
    out["disc_groups"] = {int(d): (int(n[d]), int(sq[d]), sp[d] / n[d])
                          for d in np.nonzero(n)[0]}
    key = t["l_orderkey"].to_numpy()
    if key.min() < 0 or key.max() >= 1 << 32:
        raise AssertionError("order keys outside [0, 2^32)")
    # a stable argsort by key as two stable radix passes of 16 bits
    lo = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
    order = lo[np.argsort((key[lo] >> 16).astype(np.uint16), kind="stable")]
    counts = np.bincount(key)
    keys = np.nonzero(counts)[0]
    counts = counts[keys]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    mask = np.bitwise_or.reduceat(
        (np.int64(1) << rf[order].astype(np.int64)), starts)
    out["order_lines"] = (keys, counts, ship[order], mask, rfv)
    return out


def aggtypes_queries(h1, h8, d1, d8):
    """name -> (session, run) over the lineitem caches and the decimal
    lineitem's; each run returns what validate_aggtypes reads."""
    H, api = helpers(), port_api()

    def rows(df, keys, cols):
        d = df.collect().to_pydict()
        return {tuple(d[k][i] for k in keys): tuple(d[c][i] for c in cols)
                for i in range(len(d[keys[0]]))}

    def cents(v):
        return None if v is None else int(v.scaleb(2))

    def q1_dec():
        return {k: (cents(v[0]), cents(v[1]), v[2], v[3], v[4], v[5],
                    cents(v[6]), cents(v[7]))
                for k, v in rows(H.q1_dec(api, d1.li),
                                 ("l_returnflag", "l_linestatus"),
                                 ("sq", "sp", "sdp", "mq", "md", "cnt",
                                  "mind", "maxp")).items()}

    def disc_groups():
        return {cents(k[0]): (v[0], cents(v[1]), v[2])
                for k, v in rows(H.disc_groups(api, d8.li), ("l_discount",),
                                 ("n", "sq", "mp")).items()}

    def order_lines():
        import pyarrow.compute as pc
        t = H.order_lines(api, h8.li).collect().sort_by("l_orderkey")
        ships = t["ships"].combine_chunks()
        flags = t["flags"].combine_chunks()
        enc = pc.dictionary_encode(flags.flatten())
        return (t["l_orderkey"].to_numpy(),
                pc.list_value_length(ships).to_numpy(),
                ships.flatten().to_numpy(),
                pc.list_value_length(flags).to_numpy(),
                flags.offsets.to_numpy(),
                enc.indices.to_numpy(), enc.dictionary.to_pylist())

    return {
        "q72shfl_x3": (h1.s, lambda: {
            k[0]: v for k, v in rows(H.q72shfl_x3(api, h1.li), ("k",),
                                     ("s", "c")).items()}),
        "q1_dec": (d1.s, q1_dec),
        "q6_dec": (d1.s, lambda: H.q6_dec(api, d1.li).collect()[
            "revenue"][0].as_py()),
        "disc_groups": (d8.s, disc_groups),
        "order_lines": (h8.s, order_lines),
    }


def validate_aggtypes(name, got, want):
    """(correct, how the check compared)."""
    if name == "q72shfl_x3":
        return set(got) == set(want) and all(
            _close(got[k][0], want[k][0]) and got[k][1] == want[k][1]
            for k in want), "every group: sum to 1e-6, count exact"
    if name == "q6_dec":
        return _close(got, want), "FLOAT64 revenue to 1e-6"
    if name == "q1_dec":
        return set(got) == set(want) and all(
            got[k][:2] == want[k][:2] and got[k][5:] == want[k][5:]
            and all(_close(a, b) for a, b in zip(got[k][2:5], want[k][2:5]))
            for k in want), ("decimal sums, count, min and max exact; the "
                             "FLOAT64 product sum and averages to 1e-6")
    if name == "disc_groups":
        return set(got) == set(want) and all(
            got[k][:2] == want[k][:2] and _close(got[k][2], want[k][2])
            for k in want), ("count and decimal sum exact, the average to "
                             "1e-6")
    keys, counts, ships, mask, rfv = want
    g_keys, g_counts, g_ships, f_lens, f_off, f_idx, f_dict = got
    code = np.array([rfv.index(v) for v in f_dict], np.int64)
    bits = np.int64(1) << code[f_idx]
    g_mask = np.bitwise_or.reduceat(bits, f_off[:-1]) if len(bits) \
        else np.zeros(0, np.int64)
    popcount = sum((mask >> b) & 1 for b in range(len(rfv)))
    ok = (np.array_equal(g_keys, keys) and np.array_equal(g_counts, counts)
          and np.array_equal(g_ships, ships)
          and np.array_equal(g_mask, mask)
          and np.array_equal(f_lens, popcount))
    return bool(ok), ("collect_list in input order (the JAX package's "
                      "order: a stable argsort by key), element for "
                      "element; collect_set as sets with no duplicate")


#: what each aggregate-type query must have run: operators, the modes of
#: its aggregates from the root down, and its aggregate routes per run
#: (exactly: disc_groups' coalesce makes two batches of the eight
#: partitions, so two updates and a merge)
AGGTYPES_EXPECT = {
    "q72shfl_x3": ({"UnionExec", "CollectExchangeExec"}, ["final", "partial"],
                   {"_chunked_segsum_agg": 3, "_segsum_or_fallback": 12,
                    "_scatter_agg": 4}),
    "q1_dec": ({"CachedScanExec"}, ["complete"], {"_bucket_update": 1}),
    "q6_dec": ({"CachedScanExec"}, ["complete"], {"_global_update": 1}),
    "disc_groups": ({"CollectExchangeExec", "CoalesceBatchesExec"},
                    ["complete"], {"_scatter_agg": 3}),
    "order_lines": ({"ShuffleExchangeExec"}, ["complete"], {"_sort_agg": 8}),
}
#: kernel launches per run: B2 in q72shfl_x3's twelve chunks (four a
#: partial), B1 once per input batch into order_lines' exchange
AGGTYPES_LAUNCHES = {"q72shfl_x3": {"segsum": 12},
                     "order_lines": {"murmur3_int32": 8}}


def _agg_modes(session):
    return [e.mode for e in session.last_exec.walk()
            if type(e).__name__ == "HashAggregateExec"]


def phase_aggtypes(table, want, h1, h8, spy, prof=None):
    """The aggregate types over the joins phase's lineitem caches and the
    decimal lineitem cached with 1 and 8 partitions."""
    import torch
    from types import SimpleNamespace
    H = helpers()
    t0 = time.perf_counter()
    ref = aggtypes_reference(table, want)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = H.lineitem_dec(table)
    s1, s8 = device_session(), device_session()
    d1 = SimpleNamespace(s=s1, li=s1.create_dataframe(dec).cache())
    d8 = SimpleNamespace(s=s8, li=s8.create_dataframe(
        dec, num_partitions=8).cache())
    counts = [d1.li.count(), d8.li.count()]
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    del dec
    emit({"phase": "aggtypes.setup", "rows": table.num_rows,
          "host_reference_s": host_s, "cache_s": cache_s})
    if counts != [table.num_rows] * 2:
        raise AssertionError(f"cached counts {counts}")
    reset_launches()
    spy.take()
    problems = []
    queries = aggtypes_queries(h1, h8, d1, d8)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        modes = _agg_modes(session)
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good, how = validate_aggtypes(name, got, ref[name])
        counts = spy.take()
        routes = {k: v // RUNS for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        e_ops, e_modes, e_routes = AGGTYPES_EXPECT[name]
        e_launch = {k: AGGTYPES_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not good:
            problems.append(f"{name} disagrees with numpy ({how})")
        if not e_ops <= set(execs) or modes != e_modes \
                or routes != e_routes or any(v % RUNS for v in counts.values()):
            problems.append(f"{name} ran {execs} with aggregate modes "
                            f"{modes}, routes {routes}; expected "
                            f"{AGGTYPES_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "aggtypes.query", "query": name, "correct": good,
              "check": how, "cold_s": cold, "warm_s": min(warm),
              "launches": launches, "routes": routes, "execs": execs,
              "agg_modes": modes,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "aggtypes", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("aggtypes", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 12: one operator on the CPU, the rest of the query on the card
# ---------------------------------------------------------------------------

#: the reason each fallback query's one CPU node must give
FALLBACK_REASONS = {"fb_strmax": "Min over strings not supported on device",
                    "fb_moving_min": "bounded-rows min/max window"}
#: kernel launches per run on the device side of the fallback: none in
#: fb_strmax (its projection, upper(l_comment), folds into the CPU
#: aggregate, as column pruning does in the JAX package); B1 under the
#: hash exchange and B2 in the chunked segsum route below the CPU window
FALLBACK_LAUNCHES = {"fb_strmax": {},
                     "fb_moving_min": {"murmur3_int32": 1, "segsum": 4}}


def fallback_reference(text, table):
    """Host answers to the fallback queries: fb_strmax by pyarrow (the
    comments are ASCII, so ascii_upper is upper), fb_moving_min by numpy
    (daily sums by bincount, then the minimum of each 7-day window of the
    days that have lines)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    t = text.filter(pc.less_equal(text["l_quantity"], 1.0))
    g = pa.table({"f": t["l_returnflag"], "s": t["l_linestatus"],
                  "c": pc.ascii_upper(t["l_comment"])}).group_by(
        ["f", "s"]).aggregate([("c", "min"), ("c", "max"), ("c", "count")])
    strmax = {(f, st): (mn, mx, n) for f, st, mn, mx, n in zip(
        *(g[c].to_pylist() for c in ("f", "s", "c_min", "c_max",
                                     "c_count")))}
    day = table["l_shipdate"].to_numpy().astype(np.int64)
    lo = int(day.min())
    sums = np.bincount(day - lo, weights=table["l_quantity"].to_numpy())
    days = np.nonzero(np.bincount(day - lo))[0]
    s = sums[days]
    min7 = np.array([s[max(0, i - 6):i + 1].min() for i in range(len(s))])
    moving = {int(d) + lo: (v, m, v / m) for d, v, m in zip(days, s, min7)}
    return {"fb_strmax": strmax, "fb_moving_min": moving}


def validate_fallback(name, got, want) -> bool:
    d = got.to_pydict()
    if name == "fb_strmax":
        return {(f, s): (mn, mx, n) for f, s, mn, mx, n in zip(
            d["l_returnflag"], d["l_linestatus"], d["min_c"], d["max_c"],
            d["n"])} == want
    return len(d["l_shipdate"]) == len(want) and all(
        k in want and all(_close(a, b, 1e-12) for a, b in zip(row, want[k]))
        for k, row in zip(d["l_shipdate"], zip(d["s"], d["min7"],
                                                d["ratio"])))


def phase_fallback(li_plan, text_plan, want, spy, prof=None):
    """fb_strmax over the strings path's cached lineitem_text and
    fb_moving_min over the joins path's cached lineitem, each in a session
    whose test mode allows exactly its one CPU node."""
    import torch
    from spark_rapids_tpu_torch.exec.nodes import CpuFallbackExec
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    api = port_api()
    queries = {}
    for name, plan in (("fb_strmax", text_plan), ("fb_moving_min", li_plan)):
        session = device_session(allowed=H.FALLBACK_NODES[name])
        queries[name] = (session, getattr(H, name)(
            api, DataFrame(plan, session)).collect)
    reset_launches()
    spy.take()
    problems = []
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate_fallback(name, got, want[name])
        routes = {k: v // RUNS for k, v in spy.take().items()}
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        e_launch = {k: FALLBACK_LAUNCHES[name].get(k, 0) for k in launches}
        report = session.last_meta.explain()
        cpu_lines = [ln.strip() for ln in report.splitlines()
                     if ln.lstrip().startswith("!")]
        [fb] = [e for e in session.last_exec.walk()
                if isinstance(e, CpuFallbackExec)]
        host_ms = sum(fb.transfers[k] for k in ("download_ms", "cpu_ms",
                                                "upload_ms"))
        if not good:
            problems.append(f"{name} disagrees with the host answer")
        if len(cpu_lines) != 1 or type(fb.plan).__name__ \
                != H.FALLBACK_NODES[name] \
                or FALLBACK_REASONS[name] not in report:
            problems.append(f"{name} placed {cpu_lines} on the CPU: "
                            f"{report}")
        if not fb.transfers["output_device"].startswith("cuda"):
            problems.append(f"{name} uploaded to "
                            f"{fb.transfers['output_device']}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        if name == "fb_moving_min" and "_chunked_segsum_agg" not in routes:
            problems.append(f"fb_moving_min took routes {routes}")
        emit({"phase": "fallback.query", "query": name, "correct": good,
              "cold_s": cold, "warm_s": min(warm), "cpu_nodes": cpu_lines,
              "fallback": dict(fb.transfers),
              # the metrics are the last run's: its share of that run
              "host_share": host_ms / 1e3 / warm[-1],
              "launches": launches, "routes": routes,
              "execs": _exec_names(session), "result_rows": got.num_rows,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "fallback", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("fallback", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 15: the datetime functions, a session timezone and the string casts
# ---------------------------------------------------------------------------

def _zone_offsets_us(zone, first_hour, n_hours, wall=False):
    """The zone's UTC offset (us) in each of n_hours hours from
    first_hour (hours since the epoch), by Python's zoneinfo (read from
    the TZif file the port's tzdb serves): at the hour's start instant,
    or with ``wall`` for the hour read as the zone's wall clock (fold=0,
    the earlier offset). Every zone changes its offset on whole hours of
    both clocks in these years, so one lookup serves the hour."""
    import datetime as dtm
    from zoneinfo import ZoneInfo
    from spark_rapids_tpu_torch.expr import tzdb
    with open(tzdb.source(zone), "rb") as f:
        z = ZoneInfo.from_file(f, key=zone)
    epoch = dtm.datetime(1970, 1, 1)
    out = np.empty(n_hours, np.int64)
    for k in range(n_hours):
        t = epoch + dtm.timedelta(hours=int(first_hour) + k)
        if wall:
            off = t.replace(tzinfo=z, fold=0).utcoffset()
        else:
            off = t.replace(tzinfo=dtm.timezone.utc).astimezone(z) \
                .utcoffset()
        out[k] = off // dtm.timedelta(microseconds=1)
    return out


def _exact_sums(key, vals, n):
    """Exact int64 sums of vals per key (two float bincounts of 31-bit
    halves; every partial sum stays below 2^53)."""
    lo = (vals & 0x7FFFFFFF).astype(np.float64)
    hi = (vals >> 31).astype(np.float64)
    s_lo = np.bincount(key, weights=lo, minlength=n)
    s_hi = np.bincount(key, weights=hi, minlength=n)
    return [int(h) * (1 << 31) + int(v) for h, v in zip(s_hi, s_lo)]


def datetime_reference(t):
    """numpy answers to the datetime shapes over lineitem_dt, with the
    calendar from numpy's datetime64 and python's datetime (not the
    engine's civil arithmetic), and the zones' offsets from Python's
    zoneinfo (not the engine's TZif parser)."""
    import datetime as dtm
    H = helpers()
    day_us = H.DAY_US
    days = t["l_shipdate"].cast("int32").to_numpy().astype(np.int64)
    us = t["l_commit_ts"].cast("int64").to_numpy()
    price = t["l_extendedprice"].to_numpy()
    disc = t["l_discount"].to_numpy()
    qty = t["l_quantity"].to_numpy()
    rev = price * (1.0 - disc)
    out = {}

    # python's calendar per day, from the day before the first ship day
    # (a local day in a zone west of UTC) to the last, looked up by day
    d0 = int(days.min())
    span = int(days.max()) - d0 + 1
    base = d0 - 1
    cal = [dtm.date(1970, 1, 1) + dtm.timedelta(days=base + k)
           for k in range(span + 1)]
    year_of = np.array([c.year for c in cal])
    month_of = np.array([c.month for c in cal])
    dow = np.array([c.isoweekday() % 7 + 1 for c in cal])
    iso_week = np.array([c.isocalendar()[1] for c in cal])
    next_mon = np.array([base + k + 7 - c.weekday() for k, c in
                         enumerate(cal)])

    def ym_of(d):
        return year_of[d - base], month_of[d - base]

    y, m = ym_of(days)
    y0 = int(y.min())
    key = (y - y0) * 12 + (m - 1)
    nk = int(key.max()) + 1
    n = np.bincount(key, minlength=nk)
    s = np.bincount(key, weights=rev, minlength=nk)
    out["dt_year_month"] = {(int(k // 12 + y0), int(k % 12 + 1)):
                            (s[k], int(n[k])) for k in np.nonzero(n)[0]}
    out["sql_dt"] = {(yy, mm, (mm - 1) // 3 + 1): v for (yy, mm), v in
                     out["dt_year_month"].items() if yy >= 1995}
    lo, hi = (dtm.date(1994, 1, 1) - dtm.date(1970, 1, 1)).days, \
        (dtm.date(1995, 1, 1) - dtm.date(1970, 1, 1)).days
    keep = (days >= lo) & (days < hi) & (disc >= 0.05) & (disc <= 0.07) \
        & (qty < 24.0)
    out["dt_q6_add_months"] = float(np.sum(price[keep] * disc[keep]))
    cday = np.floor_divide(us, day_us)
    n = np.bincount(cday - d0, minlength=span)
    s = np.bincount(cday - d0, weights=rev, minlength=span)
    out["dt_daily_repart"] = {d0 + k: (int(dow[d0 + k - base]), s[k],
                                       int(n[k]))
                              for k in np.nonzero(n)[0]}
    hour = np.floor_divide(us, 3_600_000_000) % 24
    _, cm = ym_of(cday)
    gkey = (hour * 8 + dow[cday - base]) * 5 + (cm - 1) // 3 + 1
    n = np.bincount(gkey)
    s = np.bincount(gkey, weights=qty)
    groups = {(int(k // 40), int(k // 5 % 8), int(k % 5)): (int(n[k]), s[k])
              for k in np.nonzero(n)[0]}
    rows = np.nonzero(qty < H.DT_ROWS_QTY)[0]
    rd, ru = days[rows], us[rows]
    ry, rm = ym_of(rd)
    rmon = rd.astype("datetime64[D]").astype("datetime64[M]")
    first = rmon.astype("datetime64[D]").astype(np.int64)
    last = (rmon + 1).astype("datetime64[D]").astype(np.int64) - 1
    # months_between(ts, 1995-01-01): whole months, and a 31-day
    # fraction unless the day of month is the 1st (not a month's last)
    ed = (rd - first + 1).astype(np.float64)
    months = ((ry - 1995) * 12 + rm - 1).astype(np.float64)
    tod = (ru - np.floor_divide(ru, day_us) * day_us).astype(np.float64)
    frac = np.where(ed == 1.0, 0.0,
                    (ed * 86400 + tod / 1e6 - 86400.0) / (31.0 * 86400))
    out["dt_ts_rows"] = {
        "l_orderkey": t["l_orderkey"].to_numpy()[rows],
        "th": ru - ru % 3_600_000_000, "ut": np.floor_divide(ru, 10 ** 6),
        "w": iso_week[np.floor_divide(ru, day_us) - base], "ld": last,
        "dd": rd - hi, "mb": np.round((months + frac) * 1e8) / 1e8,
        "nd": next_mon[rd - base],
        "md": first, "da": rd + 30, "ds": rd - 30}
    out["dt_ts_parts"] = (groups, out.pop("dt_ts_rows"))
    # the session zone: offsets per UTC hour
    h0 = int(np.floor_divide(us.min(), 3_600_000_000))
    hidx = np.floor_divide(us, 3_600_000_000) - h0
    nh = int(hidx.max()) + 1
    local = us + _zone_offsets_us(H.DT_SESSION_ZONE, h0, nh)[hidx]
    lday = np.floor_divide(local, day_us)
    lhour = np.floor_divide(local, 3_600_000_000) % 24
    ly, lm = ym_of(lday)
    ly0 = int(ly.min())
    tkey = ((ly - ly0) * 12 + lm - 1) * 24 + lhour
    n = np.bincount(tkey)
    tz_hours = {(int(k // 288 + ly0), int(k // 24 % 12 + 1),
                 int(k % 24)): int(n[k]) for k in np.nonzero(n)[0]}
    l0 = int(lday.min())
    n = np.bincount(lday - l0)
    tz_days = {l0 + int(k): int(n[k]) for k in np.nonzero(n)[0]}
    from_s = np.floor_divide(
        us + _zone_offsets_us(H.DT_FROM_ZONE, h0, nh)[hidx], 10 ** 6)
    to_s = np.floor_divide(
        us - _zone_offsets_us(H.DT_TO_ZONE, h0, nh, wall=True)[hidx],
        10 ** 6)
    sf, st = _exact_sums(lhour, from_s, 24), _exact_sums(lhour, to_s, 24)
    out["dt_tz_session"] = (tz_hours, tz_days,
                            {h: (sf[h], st[h]) for h in range(24)})
    okey = t["l_orderkey"].to_numpy()
    n_rows = len(days)
    years = y  # every ship-date string starts with its year
    uh = np.floor_divide(us, 3_600_000_000)
    u0 = int(uh.min())
    n = np.bincount(uh - u0)
    labels = np.datetime_as_string(
        (np.nonzero(n)[0] + u0).astype("datetime64[h]"))
    hours = {str(lab).replace("T", " "): int(c) for lab, c in
             zip(labels, n[np.nonzero(n)[0]])}
    out["dt_cast_strings"] = ((n_rows, n_rows, len(okey),
                               float(np.sum(years))), hours)
    fb = days[qty == 1.0].astype("datetime64[D]").astype("datetime64[M]")
    mon, cnt = np.unique(fb, return_counts=True)
    out["dt_format_fb"] = {str(k): int(c) for k, c in zip(mon, cnt)}
    return out


def datetime_queries(c1, c8, ny, fb, sql_s):
    """name -> (session, run) over lineitem_dt: c1/c8 its 1- and
    8-partition caches (c.s, c.li), ny the 1-partition cache in a session
    in DT_SESSION_ZONE, fb in a session whose test mode allows the one CPU
    node, sql_s a session with the cache as the temp view lineitem_dt.
    Each run returns what validate_datetime reads."""
    H, api = helpers(), port_api()

    def rows(df, nkeys):
        d = df.collect().to_pydict()
        names = list(d)
        return {tuple(d[k][i] for k in names[:nkeys]):
                tuple(d[c][i] for c in names[nkeys:])
                for i in range(len(d[names[0]]))}

    def as_int(t):
        import pyarrow as pa
        out = {}
        for name in t.column_names:
            c = t[name]
            if pa.types.is_date32(c.type):
                c = c.cast(pa.int32())
            elif pa.types.is_timestamp(c.type):
                c = c.cast(pa.int64())
            out[name] = c.to_numpy()
        return out

    def epoch_day(v):
        import datetime as dtm
        return (v - dtm.date(1970, 1, 1)).days

    def daily():
        return {epoch_day(k[0]): v for k, v in
                rows(H.dt_daily_repart(api, c8.li), 1).items()}

    def ts_parts():
        return (rows(H.dt_ts_groups(api, c1.li), 3),
                as_int(H.dt_ts_rows(api, c1.li).collect()))

    def tz_session():
        days = {epoch_day(k[0]): v[0] for k, v in
                rows(H.dt_tz_days(api, ny.li), 1).items()}
        return ({k: v[0] for k, v in rows(H.dt_tz_hours(api, ny.li),
                                          3).items()}, days,
                {k[0]: v for k, v in rows(H.dt_tz_shifts(api, ny.li),
                                          1).items()})

    def cast_strings():
        [checks] = rows(H.dt_cast_checks(api, c1.li), 0).values()
        return checks, {k[0]: v[0] for k, v in
                        rows(H.dt_ts_string_hours(api, c1.li), 1).items()}

    return {
        "dt_year_month": (c1.s, lambda: rows(H.dt_year_month(api, c1.li),
                                             2)),
        "dt_q6_add_months": (c1.s, lambda: H.dt_q6_add_months(
            api, c1.li).collect()["revenue"][0].as_py()),
        "dt_daily_repart": (c8.s, daily),
        "dt_ts_parts": (c1.s, ts_parts),
        "dt_tz_session": (ny.s, tz_session),
        "dt_cast_strings": (c1.s, cast_strings),
        "dt_format_fb": (fb.s, lambda: {k[0]: v[0] for k, v in rows(
            H.dt_format_fb(api, fb.li), 1).items()}),
        "sql_dt": (sql_s, lambda: rows(sql_s.sql(H.SQL_DT), 3)),
    }


def validate_datetime(name, got, want):
    """(correct, how the check compared)."""
    def groups(g, w, tol_cols=()):
        return set(g) == set(w) and all(
            all((_close(a, b) if i in tol_cols else a == b)
                for i, (a, b) in enumerate(zip(g[k], w[k]))) for k in w)
    if name in ("dt_year_month", "sql_dt"):
        return groups(got, want, (0,)), ("every group: revenue to 1e-6, "
                                         "lines exact")
    if name == "dt_q6_add_months":
        return _close(got, want), "revenue to 1e-6"
    if name == "dt_daily_repart":
        return groups(got, want, (1,)), ("every day: its day of the week "
                                         "and lines exact, revenue to 1e-6")
    if name == "dt_ts_parts":
        g_groups, g_rows = got
        w_groups, w_rows = want
        same_rows = set(g_rows) == set(w_rows) and all(
            np.array_equal(g_rows[k], w_rows[k]) for k in w_rows
            if k != "mb") and np.allclose(g_rows["mb"], w_rows["mb"],
                                          rtol=0, atol=1e-12)
        return groups(g_groups, w_groups, (1,)) and same_rows, (
            "every (hour, day of week, quarter): lines exact, quantity to "
            "1e-6; the row query row by row, exactly, months_between to "
            "1e-12")
    if name == "dt_tz_session":
        return got[0] == want[0] and got[1] == want[1] \
            and got[2] == want[2], ("local year/month/hour and local-day "
                                    "counts, and the shifted epoch-second "
                                    "sums per local hour, exactly")
    if name == "dt_cast_strings":
        return got[0] == want[0] and got[1] == want[1], (
            "parsed and round-tripped counts, the year sum and the lines "
            "per rendered hour, exactly")
    return got == want, "lines per month exactly"


#: what each datetime query must have run per run: operators that must be
#: present, its aggregate routes, and the plan nodes on the CPU (worked
#: out on a CPU rehearsal; the route gates follow the capacities of the
#: 30M-row caches: 2^25 rows in one batch, 4 chunks of 2^23)
DATETIME_EXPECT = {
    "dt_year_month": ({"CachedScanExec", "HashAggregateExec"},
                      {"_scatter_agg": 1}, []),
    "dt_q6_add_months": ({"CachedScanExec"}, {"_global_update": 1}, []),
    "dt_daily_repart": ({"ShuffleExchangeExec", "CollectExchangeExec"},
                        {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
                         "_scatter_agg": 1}, []),
    "dt_ts_parts": ({"FilterExec", "ProjectExec"},
                    {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
                     "_scatter_agg": 1}, []),
    "dt_tz_session": ({"HashAggregateExec"}, {"_scatter_agg": 3}, []),
    "dt_cast_strings": ({"HashAggregateExec"},
                        {"_global_update": 1, "_sort_agg": 1}, []),
    "dt_format_fb": ({"CpuFallbackExec", "FilterExec"}, {},
                     [helpers().DT_FALLBACK_NODE]),
    "sql_dt": ({"HashAggregateExec"},
               {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
                "_scatter_agg": 5}, []),
}
#: kernel launches per run: B1 once per input batch into dt_daily_repart's
#: exchange (its DATE key is an int32 plane); B2 in the four chunks of
#: dt_daily_repart (~13,600 lines a day), of dt_ts_parts' grouping (672
#: groups of ~45,000 lines) and of sql_dt, whose month groups pass
#: MAX_GROUP_ROWS in every chunk, so the scatter route redoes each chunk
DATETIME_LAUNCHES = {"dt_daily_repart": {"murmur3_int32": 8, "segsum": 4},
                     "dt_ts_parts": {"segsum": 4},
                     "sql_dt": {"segsum": 4}}


def phase_datetime(table, spy, prof=None):
    """The datetime shapes over lineitem_dt (from the 30M-row lineitem),
    cached on the card with 1 and 8 partitions, in sessions in test mode:
    UTC, DT_SESSION_ZONE, and one that allows dt_format_fb's CPU node."""
    import torch
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.exec.nodes import CpuFallbackExec
    from spark_rapids_tpu_torch.expr import tzdb
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    zones = {z: tzdb.source(z) for z in (H.DT_SESSION_ZONE, H.DT_FROM_ZONE,
                                         H.DT_TO_ZONE)}
    # each zone's last transition in its TZif file, and the year through
    # which the footer's rule extends the table (ROADMAP C15)
    spans = {z: dict(zip(("last_tzif_year", "table_horizon_year",
                          "entries"), tzdb.table_span(z))) for z in zones}
    emit({"phase": "datetime.zones", "sources": zones, "spans": spans,
          "new_york_file": os.path.isfile(
              "/usr/share/zoneinfo/America/New_York")})
    t0 = time.perf_counter()
    dt = H.lineitem_dt(table)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = datetime_reference(dt)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, s8 = device_session(), device_session()
    c1 = SimpleNamespace(s=s1, li=s1.create_dataframe(dt).cache())
    c8 = SimpleNamespace(s=s8, li=s8.create_dataframe(
        dt, num_partitions=8).cache())
    counts = [c1.li.count(), c8.li.count()]
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    rows = dt.num_rows
    del dt
    ny_s = device_session({"spark.sql.session.timeZone": H.DT_SESSION_ZONE})
    ny = SimpleNamespace(s=ny_s, li=DataFrame(c1.li.plan, ny_s))
    fb_s = device_session(allowed=H.DT_FALLBACK_NODE)
    fb = SimpleNamespace(s=fb_s, li=DataFrame(c1.li.plan, fb_s))
    sql_s = device_session()
    sql_s.create_or_replace_temp_view("lineitem_dt",
                                      DataFrame(c1.li.plan, sql_s))
    emit({"phase": "datetime.setup", "rows": rows, "make_s": make_s,
          "host_reference_s": host_s, "cache_s": cache_s,
          "cache_gb": torch.cuda.memory_allocated() / 2 ** 30})
    if counts != [rows] * 2:
        raise AssertionError(f"cached counts {counts}")
    reset_launches()
    spy.take()
    problems = []
    queries = datetime_queries(c1, c8, ny, fb, sql_s)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good, how = validate_datetime(name, got, ref[name])
        counts = spy.take()
        routes = {k: v // RUNS for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // RUNS
                    for k, v in read_launches().items()}
        cpu_nodes = [type(m.plan).__name__ for m in session.last_meta.walk()
                     if not m.can_run_on_tpu]
        fallback = [dict(e.transfers) for e in session.last_exec.walk()
                    if isinstance(e, CpuFallbackExec)]
        e_ops, e_routes, e_cpu = DATETIME_EXPECT[name]
        e_launch = {k: DATETIME_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not good:
            problems.append(f"{name} disagrees with numpy ({how})")
        if not e_ops <= set(execs) or routes != e_routes \
                or any(v % RUNS for v in counts.values()) or cpu_nodes != e_cpu:
            problems.append(f"{name} ran {execs} with routes {routes} and "
                            f"CPU nodes {cpu_nodes}; expected "
                            f"{DATETIME_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "datetime.query", "query": name, "correct": good,
              "check": how, "cold_s": cold, "warm_s": min(warm),
              "warm_ms": min(warm) * 1e3, "launches": launches,
              "routes": routes, "execs": execs, "cpu_nodes": cpu_nodes,
              "fallback": fallback,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "datetime", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("datetime", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 16: the string and regex layer over lineitem_text
# ---------------------------------------------------------------------------

def _np_hive_strings(offsets, data):
    """Java String.hashCode of each row's UTF-8 bytes taken as signed, the
    low 32 bits in int64: one numpy step per byte position."""
    starts, lens = offsets[:-1], np.diff(offsets)
    h = np.zeros(len(lens), np.int64)
    last = max(len(data) - 1, 0)
    for i in range(int(lens.max()) if len(lens) else 0):
        b = data[np.minimum(starts + i, last)].view(np.int8).astype(np.int64)
        h = np.where(lens > i, (h * 31 + b) & 0xFFFFFFFF, h)
    return h


def _string_planes(strings):
    """(int64 offsets, uint8 bytes) of a pyarrow string column."""
    import pyarrow as pa
    arr = pa.chunked_array(strings).combine_chunks().cast(pa.large_string())
    offsets = np.frombuffer(arr.buffers()[1], np.int64)[
        arr.offset: arr.offset + len(arr) + 1]
    data = arr.buffers()[2]
    return offsets, np.frombuffer(data, np.uint8) if data is not None \
        else np.zeros(0, np.uint8)


def np_hive_hash(comment, quantity):
    """hive_hash(comment string, quantity double) as Hive computes it: h =
    31 * h + column hash, wrapping like a Java int."""
    hs = _np_hive_strings(*_string_planes(comment))
    bits = np.where(quantity == 0.0, 0.0, quantity).view(np.uint64)
    hq = ((bits ^ (bits >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(
        np.int64)
    h = (hs * 31 + hq) & 0xFFFFFFFF
    return np.where(h >= 1 << 31, h - (1 << 32), h)


def _soundex(s):
    """Spark's soundex: the first letter, then the codes of the following
    consonants, equal neighbours once, vowels separate them and h/w do
    not, padded with 0 to 4; a string not starting with a letter is
    returned as it is."""
    codes = {}
    for digit, letters in (("1", "BFPV"), ("2", "CGJKQSXZ"), ("3", "DT"),
                           ("4", "L"), ("5", "MN"), ("6", "R")):
        codes.update(dict.fromkeys(letters, digit))
    if not s or not s[0].isalpha():
        return s
    u = s.upper()
    out, prev = u[0], codes.get(u[0], "")
    for ch in u[1:]:
        code = codes.get(ch, "")
        if code and code != prev:
            out += code
            if len(out) == 4:
                break
        if ch not in "HW":
            prev = code
    return out.ljust(4, "0")


def _edit_distance(a, b):
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def _flag_groups(t, aggs):
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate(aggs)
    names = [f"{c}_{op}" for c, op in aggs]
    return {(a, b): tuple(v) for a, b, *v in zip(
        g["l_returnflag"].to_pylist(), g["l_linestatus"].to_pylist(),
        *[g[n].to_pylist() for n in names])}


def _threaded(fn, arr, parts=8):
    """fn over slices of a (chunked) array in threads, concatenated:
    pyarrow's kernels release the GIL, so the slices run in parallel."""
    import pyarrow as pa
    from concurrent.futures import ThreadPoolExecutor
    n = len(arr)
    step = -(-n // parts) or 1
    with ThreadPoolExecutor(parts) as pool:
        outs = list(pool.map(lambda i: fn(arr.slice(i, step)),
                             range(0, n, step)))
    return pa.chunked_array([c for o in outs for c in (
        o.chunks if isinstance(o, pa.ChunkedArray) else [o])])


def regex_reference(text):
    """Host answers to the regex phase: pyarrow's RE2 kernels over all
    30M comments (independent of both packages), pyarrow's ASCII string
    functions, zlib and a numpy Hive hash over the ~1.2M lines of few
    items, and hashlib, base64 and Python's re over the row functions' and
    Q13's lines."""
    import base64
    import hashlib
    import re
    import zlib
    import pyarrow as pa
    import pyarrow.compute as pc
    H = helpers()
    c = text["l_comment"]
    out = {}
    rlike = _threaded(lambda a: pc.match_substring_regex(a, H.RX_RLIKE), c)
    f = text.filter(rlike)
    f = f.append_column("b", pc.binary_length(f["l_comment"]))
    out["rx_rlike_flags"] = _flag_groups(f, [("b", "count"), ("b", "sum")])
    likes = pa.table({k: _threaded(lambda a, p=p: pc.match_like(a, p), c)
                      for k, p in (("u", H.RX_LIKE_NFA[0]),
                                   ("ar", H.RX_LIKE_NFA[1]),
                                   ("ly", H.RX_LIKE_PLAIN))})
    g = likes.group_by(["u", "ar", "ly"]).aggregate([("u", "count")])
    out["rx_like_nfa"] = {(a, b, d): n for a, b, d, n in zip(
        *[g[k].to_pylist() for k in ("u", "ar", "ly", "u_count")])}
    pattern, group = H.RX_EXTRACT
    named = pattern.replace("(", "(?P<w>", 1)

    def extract(a):
        return pc.struct_field(pc.extract_regex(a, named), [0])
    word = _threaded(extract, c).fill_null("")
    g = pa.table({"w": word}).group_by(["w"]).aggregate([("w", "count")])
    out["rx_extract_groups"] = dict(zip(g["w"].to_pylist(),
                                        g["w_count"].to_pylist()))
    # sql_regex: the words of the lines both filters keep, capitalized
    both = pc.and_(likes["u"], rlike)
    g = pa.table({"w": pc.utf8_capitalize(word.filter(both)),
                  "q": text["l_quantity"].filter(both)}).group_by(
        ["w"]).aggregate([("q", "count"), ("q", "sum")])
    out["sql_regex"] = {w: (n, q) for w, n, q in zip(
        g["w"].to_pylist(), g["q_count"].to_pylist(),
        g["q_sum"].to_pylist())}
    del word, likes, rlike
    pat, rep = H.RX_REPLACE
    replaced = _threaded(lambda a: pc.replace_substring_regex(a, pat, rep),
                         c)
    t = text.select(["l_returnflag", "l_linestatus"]).append_column(
        "len", pc.utf8_length(replaced))
    sums = _flag_groups(t, [("len", "sum"), ("len", "count")])
    few = pc.less(text["l_quantity"], H.RX_ROWS_QTY)
    rows = pa.table({"l_orderkey": text["l_orderkey"].filter(few),
                     "r": replaced.filter(few)})
    out["rx_replace"] = (sums, rows.sort_by([("l_orderkey", "ascending"),
                                             ("r", "ascending")]))
    del replaced
    r = text.filter(few)
    rc = r["l_comment"].cast(pa.string())
    padded = pc.binary_join_element_wise("  ", rc, " ", "")
    trim = pc.utf8_trim(padded, " ")
    lens = pc.binary_length(rc).to_numpy().astype(np.int32)
    offsets, data = _string_planes(rc)
    qty = r["l_quantity"].to_numpy()
    instr = pc.add(pc.find_substring(rc, "ly"), 1).to_numpy()
    out["rx_breadth_rows"] = _breadth_sorted(pa.table({
        "l_orderkey": r["l_orderkey"], "trim": trim,
        "ltrim": pc.utf8_ltrim(padded, " "),
        "rtrim": pc.utf8_rtrim(padded, " "),
        # the comments are lowercase ASCII words: initcap is title case
        "initcap": pc.utf8_title(rc),
        # the comments are ASCII: a first code point is a first byte
        "ascii": np.where(lens > 0, data[np.minimum(
            offsets[:-1], max(len(data) - 1, 0))], 0).astype(np.int32),
        "instr": instr.astype(np.int32), "locate": instr.astype(np.int32),
        "rep": pc.binary_repeat(pc.utf8_slice_codeunits(rc, 0, 4), 3),
        "octets": lens, "bits": lens * 8,
        "left5": pc.utf8_slice_codeunits(rc, 0, 5),
        "right5": pc.utf8_slice_codeunits(rc, -5),
        "chr": np.array([chr(64 + q) for q in range(51)])[
            qty.astype(np.int64)],
        "upper_trim": pc.ascii_upper(trim),
        "crc": np.array([zlib.crc32(s.encode()) for s in rc.to_pylist()],
                        np.int64),
        "hive": np_hive_hash(rc, qty).astype(np.int32)}))
    cpu = text.filter(pa.array(
        (text["l_quantity"].to_numpy() == 1.0)
        & (text["l_orderkey"].to_numpy() % H.RX_CPU_MOD == 0)))
    words = re.compile(r"([a-z]+)ly")
    table = str.maketrans({"a": "A", "e": "E", "i": "I", "o": None,
                           "u": None})
    rows = []
    for k, flag, s in zip(cpu["l_orderkey"].to_pylist(),
                          cpu["l_returnflag"].to_pylist(),
                          cpu["l_comment"].to_pylist()):
        b = s.encode()
        rows.append((k, hashlib.md5(b).hexdigest(),
                     hashlib.sha256(b).hexdigest(),
                     s[:50] if len(s) >= 50 else ("*" * 50)[:50 - len(s)] + s,
                     s.translate(table), " ".join(s.split(" ")[:2]),
                     flag + "|" + s, _soundex(s),
                     _edit_distance(s, "quickly"),
                     base64.b64encode(b).decode(), b.hex().upper(),
                     words.findall(s)))
    out["rx_cpu_rows_fb"] = sorted(rows)
    q1 = text.filter(pc.equal(text["l_quantity"], 1.0))
    q13 = re.compile(".*quick.*sleep.*", re.DOTALL)
    keep = pa.array([not q13.fullmatch(s)
                     for s in q1["l_comment"].to_pylist()])
    out["rx_q13_fb"] = {k: v[0] for k, v in _flag_groups(
        q1.filter(keep), [("l_orderkey", "count")]).items()}
    return out


def _breadth_sorted(t):
    """rx_breadth_rows' table with the port's column types, in a total
    order (a comment decides its other columns)."""
    import pyarrow as pa
    H = helpers()
    types = {"l_orderkey": pa.int64(), "ascii": pa.int32(),
             "instr": pa.int32(), "locate": pa.int32(), "octets": pa.int32(),
             "bits": pa.int32(), "crc": pa.int64(), "hive": pa.int32()}
    cols = ("l_orderkey",) + H.RX_BREADTH_COLS
    t = t.select(list(cols)).cast(pa.schema(
        [(k, types.get(k, pa.string())) for k in cols]))
    return t.sort_by([("l_orderkey", "ascending"), ("crc", "ascending"),
                      ("trim", "ascending")])


def regex_queries(dev, cpu_rows, q13, sql_s):
    """name -> (session, run) over the cached lineitem_text: dev its plan
    in a test-mode session, cpu_rows and q13 in sessions that allow their
    one CPU node, sql_s a session with it as the temp view lineitem_text.
    Each run returns what validate_regex reads."""
    H, api = helpers(), port_api()

    def rows(df, nkeys):
        d = df.collect().to_pydict()
        names = list(d)
        return {tuple(d[k][i] for k in names[:nkeys]):
                tuple(d[c][i] for c in names[nkeys:])
                for i in range(len(d[names[0]]))}

    def replace():
        sums = rows(H.rx_replace_sums(api, dev.li), 2)
        return sums, H.rx_replace_rows(api, dev.li).collect()

    return {
        "rx_rlike_flags": (dev.s, lambda: rows(
            H.rx_rlike_flags(api, dev.li), 2)),
        "rx_like_nfa": (dev.s, lambda: {k: v[0] for k, v in rows(
            H.rx_like_nfa(api, dev.li), 3).items()}),
        "rx_extract_groups": (dev.s, lambda: {k[0]: v[0] for k, v in rows(
            H.rx_extract_groups(api, dev.li), 1).items()}),
        "rx_replace": (dev.s, replace),
        "rx_breadth_rows": (dev.s, lambda: H.rx_breadth_rows(
            api, dev.li).collect()),
        "rx_cpu_rows_fb": (cpu_rows.s, lambda: H.rx_cpu_rows_fb(
            api, cpu_rows.li).collect()),
        "rx_q13_fb": (q13.s, lambda: {k: v[0] for k, v in rows(
            H.rx_q13_fb(api, q13.li), 2).items()}),
        "sql_regex": (sql_s, lambda: {k[0]: v for k, v in rows(
            sql_s.sql(H.SQL_REGEX), 1).items()}),
    }


def validate_regex(name, got, want):
    """(correct, how the check compared)."""
    H = helpers()
    if name == "rx_replace":
        g_sums, g_rows = got
        w_sums, w_rows = want
        g_rows = g_rows.sort_by([("l_orderkey", "ascending"),
                                 ("r", "ascending")])
        same = g_rows.num_rows == w_rows.num_rows and all(
            g_rows[k].equals(w_rows[k].cast(g_rows[k].type))
            for k in ("l_orderkey", "r"))
        return g_sums == w_sums and same, (
            "characters and lines per flag pair, then the replaced "
            "comments of the few-item lines row by row, exactly")
    if name == "rx_breadth_rows":
        got = _breadth_sorted(got)
        return got.num_rows == want.num_rows and all(
            got[k].equals(want[k]) for k in got.column_names), (
            "every column of every line, exactly")
    if name == "rx_cpu_rows_fb":
        d = got.to_pydict()
        rows = sorted(zip(d["l_orderkey"], *[d[k] for k in H.RX_CPU_COLS]))
        return rows == want, "every column of every line, exactly"
    if name == "sql_regex":
        return set(got) == set(want) and all(
            got[k][0] == want[k][0] and _close(got[k][1], want[k][1])
            for k in want), ("every word: lines exact, quantity to 1e-6")
    return got == want, "every group exactly"


#: each regex query's aggregate routes per run and its plan nodes on the
#: CPU (worked out on a CPU rehearsal at reduced rows: the flag and
#: boolean keys take the tiny-bucket route, the extracted words the sort
#: route; the size gates do not move them at 30M rows)
REGEX_EXPECT = {
    "rx_rlike_flags": ({"_bucket_update": 1}, []),
    "rx_like_nfa": ({"_bucket_update": 1}, []),
    "rx_extract_groups": ({"_sort_agg": 1}, []),
    "rx_replace": ({"_bucket_update": 1}, []),
    "rx_breadth_rows": ({}, []),
    "rx_cpu_rows_fb": ({}, ["Project"]),
    "rx_q13_fb": ({"_bucket_update": 1}, ["Filter"]),
    "sql_regex": ({"_sort_agg": 1}, []),
}
#: kernel launches per run: the case map of upper(trim(...))
REGEX_LAUNCHES = {"rx_breadth_rows": {"case_map": 1}}


def phase_regex(text, text_plan, spy, prof=None):
    """The regex and string-breadth shapes over the strings path's cached
    lineitem_text, in test-mode sessions: one for the device queries, one
    each allowing rx_cpu_rows_fb's and rx_q13_fb's CPU node, and one with
    the cache as a temp view for sql_regex."""
    import torch
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.exec.nodes import CpuFallbackExec
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    t0 = time.perf_counter()
    ref = regex_reference(text)
    host_s = time.perf_counter() - t0

    def bound(session):
        return SimpleNamespace(s=session, li=DataFrame(text_plan, session))
    dev = bound(device_session())
    cpu_rows = bound(device_session(
        allowed=H.RX_FALLBACK_NODES["rx_cpu_rows_fb"]))
    q13 = bound(device_session(allowed=H.RX_FALLBACK_NODES["rx_q13_fb"]))
    sql_s = device_session()
    sql_s.create_or_replace_temp_view("lineitem_text",
                                      DataFrame(text_plan, sql_s))
    emit({"phase": "regex.setup", "host_reference_s": host_s,
          "rows": text.num_rows})
    reset_launches()
    spy.take()
    problems = []
    queries = regex_queries(dev, cpu_rows, q13, sql_s)
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        # one warm run: the second was cut to pay for the pipeline phase
        t0 = time.perf_counter()
        fn()
        warm = [time.perf_counter() - t0]
        good, how = validate_regex(name, got, ref[name])
        counts = spy.take()
        routes = {k: v // 2 for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // 2
                    for k, v in read_launches().items()}
        cpu_nodes = [type(m.plan).__name__ for m in session.last_meta.walk()
                     if not m.can_run_on_tpu]
        fallback = [dict(e.transfers) for e in session.last_exec.walk()
                    if isinstance(e, CpuFallbackExec)]
        e_routes, e_cpu = REGEX_EXPECT[name]
        e_launch = {k: REGEX_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not good:
            problems.append(f"{name} disagrees with the host answer ({how})")
        if routes != e_routes or any(v % 2 for v in counts.values()) \
                or cpu_nodes != e_cpu:
            problems.append(f"{name} ran {execs} with routes {routes} and "
                            f"CPU nodes {cpu_nodes}; expected "
                            f"{REGEX_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "regex.query", "query": name, "correct": good,
              "check": how, "cold_s": cold, "warm_s": min(warm),
              "warm_ms": min(warm) * 1e3, "launches": launches,
              "routes": routes, "execs": execs, "cpu_nodes": cpu_nodes,
              "fallback": fallback,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "regex", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("regex", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if counts["case_map"] <= 0:
        raise AssertionError(f"the case-map kernel did not run on the "
                             f"regex path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 17: the nested types over orders_nested
# ---------------------------------------------------------------------------

def _dedup(vals):
    out = []
    for v in vals:
        if v not in out:
            out.append(v)
    return out


def nested_reference(table, orders, nested):
    """numpy and Python answers to the nested shapes, from the lineitem
    and orders themselves (the explode of orders_nested's arrays is the
    lineitem sorted stably by order key) and, for the row queries, from
    pyarrow's Python rows of the filtered orders."""
    import pyarrow.compute as pc
    H = helpers()
    out = {}
    key = table["l_orderkey"].to_numpy()
    n = orders.num_rows
    odate = orders["o_orderdate"].to_numpy()
    price = table["l_extendedprice"].to_numpy()
    qty = table["l_quantity"].to_numpy()
    priced = key % H.NX_NULL_PRICE_MOD != 0
    d = odate[key[priced]]
    days = np.bincount(d, minlength=odate.max() + 1)
    sums = np.bincount(d, weights=price[priced], minlength=odate.max() + 1)
    daily = {int(k): (float(sums[k]), int(days[k]))
             for k in np.flatnonzero(days)}
    out["nx_explode_daily"] = out["sql_nested"] = daily
    # positions: the rank of each line within its order, in lineitem order
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n)
    start = np.cumsum(counts) - counts
    pos = np.empty(len(key), np.int64)
    pos[order] = np.arange(len(key)) - start[key[order]]
    pp = pos[priced]
    pc_n = np.bincount(pp)
    pc_s = np.bincount(pp, weights=price[priced])
    okey = np.arange(n)
    null_rows = int(((okey % H.NX_NULL_PRICE_MOD == 0) | (counts == 0)).sum())
    posx = {int(p): (int(pc_n[p]), int(pc_n[p]), float(pc_s[p]))
            for p in np.flatnonzero(pc_n)}
    posx[None] = (null_rows, 0, None)
    out["nx_posexplode_outer"] = posx
    rows = nested.filter(pc.equal(pc.subtract(
        nested["o_orderkey"], pc.multiply(pc.divide(
            nested["o_orderkey"], H.NX_ROWS_MOD), H.NX_ROWS_MOD)),
        H.NX_ROWS_REM)).to_pylist()
    small = list(H.NX_SET)
    arr = {}
    for r in rows:
        q, p, s = r["l_qty"], r["l_price"], r["l_ship"]
        arr[r["o_orderkey"]] = (
            len(q), q[0] if q else None, q[-1] if q else None,
            q[39] if len(q) >= 40 else None, q[0] if q else None,
            25.0 in q, min(p) if p else None, max(p) if p else None,
            max(s) if s else None, sorted(q), sorted(q, reverse=True),
            q[1:4], _dedup(q), (q.index(10.0) + 1) if 10.0 in q else 0,
            [x for x in q if x != 1.0], any(x in small for x in q),
            _dedup(q + small), _dedup([x for x in q if x in small]),
            _dedup([x for x in q if x not in small]))
    out["nx_array_rows"] = arr
    struct_rows = {}
    for r in rows:
        m = r["o_flag_qty"]
        get = dict(m)
        struct_rows[r["o_orderkey"]] = (
            r["o_info"]["orderdate"], r["o_info"]["custkey"],
            [k for k, _ in m], [v for _, v in m], get.get("NO"),
            get.get("RF"), len(m))
    flag = table["l_returnflag"]
    code = (pc.equal(flag, "N").to_numpy().astype(np.int64) * 2
            + pc.equal(flag, "R").to_numpy().astype(np.int64) * 4
            + pc.equal(table["l_linestatus"], "O").to_numpy()
            .astype(np.int64))
    present = np.bincount(key * 6 + code, minlength=6 * n).reshape(n, 6) > 0
    per_pair = np.bincount(code, weights=qty, minlength=6)
    out["nx_struct_map"] = (struct_rows, {
        H.FLAG_PAIRS[c]: (float(per_pair[c]), int(present[:, c].sum()))
        for c in range(6)})
    out["nx_stack"] = {"qty": (float(qty.sum()), len(qty)),
                       "price": (float(price.sum()), len(price))}
    cpu_rows = {}
    for r in nested.filter(pc.and_(pc.equal(pc.subtract(
            nested["o_orderkey"], pc.multiply(pc.divide(
                nested["o_orderkey"], H.NX_CPU_MOD), H.NX_CPU_MOD)), 0),
            pc.greater(pc.list_value_length(nested["l_qty"]), 0))
            ).to_pylist():
        q, s, m = r["l_qty"], r["l_ship"], r["o_flag_qty"]
        keys = [k for k, _ in m]
        seq = list(range(1, len(q) + 1))
        cpu_rows[r["o_orderkey"]] = (
            [{"0": a, "1": b} for a, b in zip(q, s)], ",".join(keys),
            [r["o_custkey"]] * 2, seq, list(zip(seq, q)),
            list(m) + [("ZZ", 0.5)], [(k, None) for k in keys],
            [{"key": k, "value": v} for k, v in m])
    out["nx_cpu_collections_fb"] = cpu_rows
    sib = {}
    for r in rows:
        if r["l_price"] is None or not r["l_price"]:
            continue
        s, c = sib.get(len(r["l_qty"]), (0.0, 0))
        sib[len(r["l_qty"])] = (s + sum(r["l_price"]), c + len(r["l_price"]))
    out["nx_sibling_fb"] = sib
    ing = {}
    for r in rows:
        if r["l_price"]:
            dd = (r["o_info"]["orderdate"] - _EPOCH).days
            s, c = ing.get(dd, (0.0, 0))
            ing[dd] = (s + sum(r["l_price"]), c + len(r["l_price"]))
    out["ingest_generate"] = ing
    return out


def _epoch():
    import datetime as dtm
    return dtm.date(1970, 1, 1)


_EPOCH = _epoch()


def nested_queries(n1, n8, li, fb_project, fb_generate, sql_s, doc):
    """name -> (session, run) over orders_nested: n1/n8 its 1- and
    8-partition caches (n.s, n.od), li the cached lineitem (li.s, li.li),
    fb_project and fb_generate the 1-partition cache in sessions whose
    test mode allows that one CPU node, sql_s a session with
    nx_view(orders_nested) as the temp view orders_nested, doc
    ingest_generate's plan document. Each run returns what
    validate_nested reads."""
    from spark_rapids_tpu_torch.plan.ingest import ingest
    H, api = helpers(), port_api()

    def groups(df, nkeys):
        d = df.collect().to_pydict()
        names = list(d)
        return {(d[names[0]][i] if nkeys == 1
                 else tuple(d[k][i] for k in names[:nkeys])):
                tuple(d[c][i] for c in names[nkeys:])
                for i in range(len(d[names[0]]))}

    def days(g):
        return {(k - _EPOCH).days: v for k, v in g.items()}

    def by_order(df):
        return groups(df, 1)

    return {
        "nx_explode_daily": (n8.s, lambda: days(groups(
            H.nx_explode_daily(api, n8.od), 1))),
        "nx_posexplode_outer": (n1.s, lambda: groups(
            H.nx_posexplode_outer(api, n1.od), 1)),
        "nx_array_rows": (n1.s, lambda: by_order(
            H.nx_array_rows(api, n1.od))),
        "nx_struct_map": (n1.s, lambda: (
            by_order(H.nx_struct_rows(api, n1.od)),
            groups(H.nx_map_groups(api, n1.od), 1))),
        "nx_stack": (li.s, lambda: groups(H.nx_stack(api, li.li), 1)),
        "nx_cpu_collections_fb": (fb_project.s, lambda: by_order(
            H.nx_cpu_collections_fb(api, fb_project.od))),
        "nx_sibling_fb": (fb_generate.s, lambda: groups(
            H.nx_sibling_fb(api, fb_generate.od), 1)),
        "sql_nested": (sql_s, lambda: days(groups(
            sql_s.sql(H.SQL_NESTED), 1))),
        "ingest_generate": (doc[0], lambda: days(groups(
            ingest(doc[1], doc[0]), 1))),
    }


def validate_nested(name, got, want):
    """(correct, how the check compared)."""
    def close_groups(g, w, tol_cols):
        return set(g) == set(w) and all(
            all((a is None and b is None) if a is None or b is None
                else (_close(a, b, 1e-9) if i in tol_cols else a == b)
                for i, (a, b) in enumerate(zip(g[k], w[k]))) for k in w)
    if name in ("nx_explode_daily", "sql_nested", "ingest_generate",
                "nx_sibling_fb"):
        return close_groups(got, want, (0,)), (
            "every group: the count exact, the sum to 1e-9")
    if name == "nx_posexplode_outer":
        return close_groups(got, want, (2,)), (
            "every position and the null one: rows and non-null prices "
            "exact, the sum to 1e-9")
    if name == "nx_stack":
        return close_groups(got, want, (0,)), (
            "both labels: the count exact, the sum to 1e-9")
    if name == "nx_struct_map":
        return got[0] == want[0] and close_groups(got[1], want[1], (0,)), (
            "the struct and map rows exactly; per flag pair the entries "
            "exact and the quantity to 1e-9")
    return got == want, "row by row, exactly"


_CHUNKED = {"_chunked_segsum_agg": 1, "_segsum_or_fallback": 4,
            "_scatter_agg": 1}
#: what each nested query must have run per run: operators that must be
#: present, its aggregate routes, the plan nodes on the CPU and the
#: Expand forms (the CPU nodes and nx_stack's Expand per projection are
#: the JAX package's on a CPU rehearsal; the routes follow the capacities
#: of the full-size caches: the 30M exploded prices collected into one
#: batch take the chunked segsum route, as dt_daily_repart's lines do)
NESTED_EXPECT = {
    "nx_explode_daily": ({"GenerateExec", "ShuffleExchangeExec",
                          "CollectExchangeExec"}, _CHUNKED, [], []),
    "nx_posexplode_outer": ({"GenerateExec", "HashAggregateExec"},
                            {"_scatter_agg": 1}, [], []),
    "nx_array_rows": ({"FilterExec", "ProjectExec"}, {}, [], []),
    "nx_struct_map": ({"GenerateExec", "HashAggregateExec"},
                      {"_bucket_update": 1}, [], []),
    "nx_stack": ({"ExpandExec", "HashAggregateExec"}, {"_sort_agg": 3}, [],
                 [False]),
    "nx_cpu_collections_fb": ({"CpuFallbackExec", "FilterExec"}, {},
                              ["Project"], []),
    "nx_sibling_fb": ({"CpuFallbackExec", "HashAggregateExec"},
                      {"_scatter_agg": 1}, ["Generate"], []),
    "sql_nested": ({"GenerateExec", "HashAggregateExec"}, _CHUNKED, [], []),
    "ingest_generate": ({"CpuFallbackExec", "DeviceDecodeScanExec"},
                        {"_segsum_or_fallback": 1}, ["Generate"], []),
}
#: kernel launches per run: B1 once per exploded partition batch into
#: nx_explode_daily's exchange (its DATE key is an int32 plane); B2 in the
#: four 2^23-row chunks of the collected 30M prices (nx_explode_daily,
#: sql_nested) and once over ingest_generate's 300k; B3 on the one row
#: group of ingest_generate's Parquet file (o_orderdate's codes)
NESTED_LAUNCHES = {"nx_explode_daily": {"murmur3_int32": 8, "segsum": 4},
                   "sql_nested": {"segsum": 4},
                   "ingest_generate": {"segsum": 1, "bitslice": 1}}


def phase_nested(table, orders, h1, tmp_dir, spy, prof=None):
    """The nested shapes over orders_nested (one row per order of the
    joins phase's orders, its lines inside), cached with 1 and 8
    partitions, and nx_stack over the joins phase's cached lineitem, in
    sessions in test mode. Returns the launches and the 1-partition
    cache, which the formats phase reads."""
    import pyarrow.parquet as pq
    import torch
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.exec.nodes import CpuFallbackExec
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    api = port_api()
    t0 = time.perf_counter()
    nested = H.make_orders_nested(table, orders)
    flat_path = os.path.join(tmp_dir, "orders_nested_flat.parquet")
    pq.write_table(H.orders_nested_flat(nested), flat_path)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = nested_reference(table, orders, nested)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, s8 = device_session(), device_session()
    n1 = SimpleNamespace(s=s1, od=s1.create_dataframe(nested).cache())
    n8 = SimpleNamespace(s=s8, od=s8.create_dataframe(
        nested, num_partitions=8).cache())
    counts = [n1.od.count(), n8.od.count()]
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    rows, elements = nested.num_rows, table.num_rows
    del nested

    def rebound(node):
        s = device_session(allowed=node)
        return SimpleNamespace(s=s, od=DataFrame(n1.od.plan, s))
    fb_project = rebound(H.NX_FALLBACK_NODES["nx_cpu_collections_fb"])
    fb_generate = rebound(H.NX_FALLBACK_NODES["nx_sibling_fb"])
    sql_s = device_session()
    sql_s.create_or_replace_temp_view(
        "orders_nested", H.nx_view(api, DataFrame(n1.od.plan, sql_s)))
    ing_s = device_session(allowed=H.NX_FALLBACK_NODES["ingest_generate"])
    li = SimpleNamespace(s=h1.s, li=h1.li)
    emit({"phase": "nested.setup", "rows": rows, "elements": elements,
          "make_s": make_s, "host_reference_s": host_s, "cache_s": cache_s,
          "cache_gb": torch.cuda.memory_allocated() / 2 ** 30})
    if counts != [rows] * 2:
        raise AssertionError(f"cached counts {counts}")
    reset_launches()
    spy.take()
    problems = []
    queries = nested_queries(n1, n8, li, fb_project, fb_generate, sql_s,
                             (ing_s, H.nx_generate_doc(flat_path)))
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        # one warm run: the second was cut to pay for the pipeline phase
        t0 = time.perf_counter()
        fn()
        warm = [time.perf_counter() - t0]
        good, how = validate_nested(name, got, ref[name])
        counts = spy.take()
        routes = {k: v // 2 for k, v in counts.items()}
        execs = _exec_names(session)
        launches = {k: (v - before[k]) // 2
                    for k, v in read_launches().items()}
        cpu_nodes = [type(m.plan).__name__ for m in session.last_meta.walk()
                     if not m.can_run_on_tpu]
        forms = [e.stacked for e in session.last_exec.walk()
                 if type(e).__name__ == "ExpandExec"]
        fallback = [dict(e.transfers) for e in session.last_exec.walk()
                    if isinstance(e, CpuFallbackExec)]
        if not good:
            problems.append(f"{name} disagrees with numpy ({how})")
        e_ops, e_routes, e_cpu, e_forms = NESTED_EXPECT[name]
        e_launch = {k: NESTED_LAUNCHES.get(name, {}).get(k, 0)
                    for k in launches}
        if not e_ops <= set(execs) or routes != e_routes \
                or any(v % 2 for v in counts.values()) \
                or cpu_nodes != e_cpu or forms != e_forms:
            problems.append(f"{name} ran {execs} with routes {routes}, "
                            f"CPU nodes {cpu_nodes} and Expand forms "
                            f"{forms}; expected {NESTED_EXPECT[name]}")
        if launches != e_launch:
            problems.append(f"{name} launched {launches}, expected "
                            f"{e_launch}")
        emit({"phase": "nested.query", "query": name, "correct": good,
              "check": how, "cold_s": cold, "warm_s": min(warm),
              "warm_ms": min(warm) * 1e3, "launches": launches,
              "routes": routes, "execs": execs, "cpu_nodes": cpu_nodes,
              "expand_stacked": forms, "fallback": fallback,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "nested", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("nested", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if counts["murmur3_int32"] <= 0 or counts["segsum"] <= 0:
        raise AssertionError(f"murmur3 and segsum must run on the nested "
                             f"path: {counts}")
    return counts, n1


# ---------------------------------------------------------------------------
# The formats phase: lambdas, JSON, NULL and the file readers
# ---------------------------------------------------------------------------

#: fm_json_lines' documents: the first tenth of the orders (the file's
#: write and parse time); js_path_fb's and js_from_json's, the first
#: 30,000 (three host parses a document, three runs)
FM_JSON_ORDERS, JS_DOCS = 300_000, 30_000
#: fm_csv_q1's rows (the CSV write and parse time) and fm_avro's orders
#: (the pure-Python Avro codec)
FM_CSV_ROWS, FM_AVRO_ROWS = 5_000_000, 300_000


def _years(days):
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def formats_reference(table, orders, want):
    """numpy and pyarrow answers to the formats queries, from the
    lineitem and orders themselves."""
    import datetime
    import pyarrow.compute as pc
    H = helpers()
    out = {}
    key = table["l_orderkey"].to_numpy()
    n = orders.num_rows
    odate = orders["o_orderdate"].to_numpy()
    okey = np.arange(n)
    yi = _years(odate)
    y0 = int(yi.min())
    yi = yi - y0
    ny = int(yi.max()) + 1
    ly = yi[key]
    qty = table["l_quantity"].to_numpy()
    price = table["l_extendedprice"].to_numpy()
    ship = table["l_shipdate"].to_numpy()
    priced = key % H.NX_NULL_PRICE_MOD != 0
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n)
    start = np.cumsum(counts) - counts
    pos = np.empty(len(key), np.int64)
    pos[order] = np.arange(len(key)) - start[key[order]]

    def per_year(idx, w):
        return np.bincount(idx, weights=w, minlength=ny)
    n_o = np.bincount(yi, minlength=ny)
    hi = per_year(ly[priced], (price[priced] > 50000).astype(np.float64))
    big = np.zeros(n, np.bool_)
    big[key[qty >= 50]] = True
    notlate = np.zeros(n, np.bool_)
    notlate[key[ship <= odate[key]]] = True
    heavy = per_year(ly, (qty * pos > 100).astype(np.float64))
    bigs, lates = per_year(yi, big.astype(np.float64)), \
        per_year(yi, (~notlate).astype(np.float64))
    out["lx_array_preds"] = {y0 + y: (int(n_o[y]), int(hi[y]), int(bigs[y]),
                                      int(lates[y]), int(heavy[y]))
                             for y in np.flatnonzero(n_o)}
    prod = price[priced] * qty[priced]
    s = per_year(ly[priced], prod)
    c = np.bincount(ly[priced], minlength=ny)
    out["lx_zip_explode"] = {y0 + y: (float(s[y]), int(c[y]))
                             for y in np.flatnonzero(c)}
    code = (pc.equal(table["l_returnflag"], "N").to_numpy().astype(np.int64)
            * 2 + pc.equal(table["l_returnflag"], "R").to_numpy()
            .astype(np.int64) * 4 + pc.equal(table["l_linestatus"], "O")
            .to_numpy().astype(np.int64))
    comb = key * 6 + code
    v2 = np.bincount(comb, weights=qty, minlength=6 * n) * 2
    keep = (np.bincount(comb, minlength=6 * n) > 0) & (v2 > 10)
    codes = np.arange(6 * n) % 6
    ms = np.bincount(codes[keep], weights=v2[keep], minlength=6)
    mc = np.bincount(codes[keep], minlength=6)
    out["lx_map_lambdas"] = {H.FLAG_PAIRS[k].lower(): (float(ms[k]),
                                                       int(mc[k]))
                             for k in range(6) if mc[k]}
    osum = np.bincount(key, weights=qty, minlength=n)
    fold = okey % H.LX_FOLD_MOD == 0
    out["lx_fold_fb"] = {int(o): float(osum[o]) / 2
                         for o in np.flatnonzero(fold)}
    sel = key < FM_JSON_ORDERS
    b = key[sel] % H.FM_JSON_MOD
    s = np.bincount(b, weights=price[sel], minlength=H.FM_JSON_MOD)
    c = np.bincount(b, minlength=H.FM_JSON_MOD)
    out["fm_json_lines"] = {int(k): (float(s[k]), int(c[k]))
                            for k in np.flatnonzero(c)}
    cust = orders["o_custkey"].to_numpy()
    first = price[order[np.minimum(start, len(key) - 1)]]
    out["js_path_rows"] = {o: (repr(float(first[o])) if counts[o] else None,
                               str(int(cust[o]))) for o in range(JS_DOCS)}
    sel = key < JS_DOCS
    g = key[sel] % H.JS_MOD
    s = np.bincount(g, weights=price[sel], minlength=H.JS_MOD)
    c = np.bincount(g, minlength=H.JS_MOD)
    out["js_from_json"] = {int(k): (float(s[k]), int(c[k]))
                           for k in np.flatnonzero(c)}
    epoch = datetime.date(1970, 1, 1)
    out["js_to_json_fb"] = {
        int(o): '{"orderdate":"%s","custkey":%d}' % (
            (epoch + datetime.timedelta(days=int(odate[o]))).isoformat(),
            int(cust[o])) for o in np.flatnonzero(fold)}
    n_a = int(pc.sum(pc.equal(table["l_returnflag"], "A")).as_py())
    out["null_sql"] = [{"l_returnflag": "A", "z": None, "n": n_a}]
    out["fm_hive_q1"] = want["q1"]
    out["fm_hive_pruned"] = q6_reference(
        table.filter(pc.equal(table["l_returnflag"], "R")))
    head = table.slice(0, FM_CSV_ROWS)
    out["fm_csv_q1"] = q1_reference(head)
    flags = head["l_returnflag"].to_numpy(False)
    hq = head["l_quantity"].to_numpy()
    out["ingest_text_scan"] = {f: (float(hq[flags == f].sum()),
                                   int((flags == f).sum())) for f in "ANR"}
    for name, m in (("fm_orc", n), ("fm_avro", FM_AVRO_ROWS)):
        c = np.bincount(yi[:m], minlength=ny)
        s = np.bincount(yi[:m], weights=cust[:m].astype(np.float64),
                        minlength=ny)
        out[name] = {y0 + y: (int(c[y]), int(s[y]))
                     for y in np.flatnonzero(c)}
    return out


def formats_files(table, orders, tmp_dir):
    """The phase's files: lineitem in a hive layout, its head as CSV, the
    first FM_JSON_ORDERS orders as JSON lines, the orders as ORC and
    their head as Avro (the port's writer). Returns their paths and the
    documents of js_path_fb."""
    import pyarrow as pa
    import pyarrow.csv as pcsv
    import pyarrow.orc as porc
    from spark_rapids_tpu_torch.io.avro import write_avro
    H = helpers()
    paths = {k: os.path.join(tmp_dir, v) for k, v in (
        ("hive", "lineitem_hive"), ("csv", "lineitem.csv"),
        ("json", "orders.json"), ("orc", "orders.orc"),
        ("avro", "orders.avro"))}
    times = {}
    t0 = time.perf_counter()
    H.write_hive_lineitem(table, paths["hive"], **PARQUET_WRITE)
    times["hive_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcsv.write_csv(table.slice(0, FM_CSV_ROWS), paths["csv"])
    times["csv_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs = H.orders_json_lines(table, orders, FM_JSON_ORDERS)
    with open(paths["json"], "w") as f:
        f.write("\n".join(docs) + "\n")
    times["json_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    od = orders.set_column(1, "o_orderdate",
                           orders["o_orderdate"].cast(pa.date32()))
    porc.write_table(od, paths["orc"])
    times["orc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_avro(paths["avro"], od.slice(0, FM_AVRO_ROWS), codec="deflate")
    times["avro_s"] = time.perf_counter() - t0
    return paths, docs[:JS_DOCS], times


def formats_queries(n1, li, paths, docs):
    """name -> (session, fn): each query over its source, in a session in
    test mode that allows its CPU nodes (FORMATS_CPU_NODES)."""
    from spark_rapids_tpu_torch.plan.ingest import ingest
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    api = port_api()

    def session(name):
        return device_session(
            allowed=",".join(H.FORMATS_CPU_NODES.get(name, [])))

    def keyed(df, key, cols):
        d = df.to_pydict()
        return {k: tuple(d[c][i] for c in cols)
                for i, k in enumerate(d[key])}
    out = {}

    def over_nested(name, fn, key, cols):
        s = session(name)
        df = DataFrame(n1.od.plan, s)
        out[name] = (s, lambda: keyed(fn(api, df), key, cols))
    over_nested("lx_array_preds", H.lx_array_preds, "y",
                ("n", "hi", "big", "late", "heavy"))
    over_nested("lx_zip_explode", H.lx_zip_explode, "y", ("s", "n"))
    over_nested("lx_map_lambdas", H.lx_map_lambdas, "key", ("q", "n"))
    over_nested("lx_fold_fb", H.lx_fold_fb, "o_orderkey", ("half",))
    over_nested("js_to_json_fb", H.js_to_json_fb, "o_orderkey", ("j",))
    s = session("fm_json_lines")
    out["fm_json_lines"] = (s, lambda: keyed(H.fm_json_lines(
        api, s.read_json(paths["json"])), "b", ("s", "n")))
    sj = session("js_path_rows")
    jdocs = sj.create_dataframe({"doc": docs}).cache()

    def js_path_rows():
        d = H.js_path_rows(api, jdocs).to_pydict()
        return {int(jt[0]): (p0, jt[1]) for p0, jt in zip(d["p0"], d["jt"])}
    out["js_path_rows"] = (sj, js_path_rows)
    sf = session("js_from_json")
    fdocs = DataFrame(jdocs.plan, sf)
    out["js_from_json"] = (sf, lambda: keyed(H.js_from_json(api, fdocs),
                                             "g", ("s", "n")))
    sn = session("null_sql")
    sn.create_or_replace_temp_view("lineitem", DataFrame(li.plan, sn))
    out["null_sql"] = (sn, lambda: sn.sql(H.NULL_SQL).collect().to_pylist())
    q1 = port_queries
    sh = session("fm_hive_q1")
    out["fm_hive_q1"] = (sh, q1(sh.read_parquet(paths["hive"]))["q1"])
    sp = session("fm_hive_pruned")

    def hive_pruned():
        d = H.fm_hive_pruned(api, sp.read_parquet(paths["hive"])).to_pydict()
        return list(d.values())[0][0]
    out["fm_hive_pruned"] = (sp, hive_pruned)
    sc = session("fm_csv_q1")
    out["fm_csv_q1"] = (sc, q1(sc.read_csv(paths["csv"]))["q1"])
    for name, fmt in (("fm_orc", "orc"), ("fm_avro", "avro")):
        so = session(name)
        reader = getattr(so, f"read_{fmt}")
        out[name] = (so, lambda r=reader, p=paths[fmt]: keyed(
            H.orders_by_year(api, r(p)), "y", ("n", "c")))
    si = session("ingest_text_scan")
    out["ingest_text_scan"] = (si, lambda: keyed(ingest(
        H.text_scan_doc(paths["csv"]), si), "l_returnflag", ("q", "n")))
    return out


def validate_formats(name, got, want):
    """(correct, how): exact, but float sums within 1e-6 relative."""
    if name == "fm_hive_pruned":
        return _close(got, want), "q6 within 1e-6"
    if name in ("fm_hive_q1", "fm_csv_q1"):
        return validate("q1", got, want), "q1 as bench.py"
    if name == "null_sql":
        return got == want, "rows exact"
    if set(got) != set(want):
        return False, f"keys {sorted(set(got) ^ set(want))[:5]} differ"
    floats = name in ("lx_zip_explode", "lx_map_lambdas", "fm_json_lines",
                      "js_from_json", "ingest_text_scan")
    for k in want:
        g, w = got[k], want[k]
        if floats:
            if not (_close(g[0], w[0]) and g[1] == w[1]):
                return False, f"{k}: {g} != {w}"
        elif tuple(g) != (w if isinstance(w, tuple) else (w,)):
            return False, f"{k}: {g} != {w}"
    return True, ("sums within 1e-6, counts exact" if floats else "exact")


def _scan_files(session):
    """(files kept, files) of the query's Parquet scans."""
    from spark_rapids_tpu_torch.exec import nodes as X
    scans = [e for e in session.last_exec.walk()
             if isinstance(e, (X.ParquetScanExec,
                               X.EncodedParquetSourceExec))]
    return [sum(len(e._kept_files) for e in scans),
            sum(len(e.plan.paths) for e in scans)] if scans else None


def phase_formats(table, orders, want, n1, h1, tmp_dir, spy, prof=None):
    """Lambdas over the nested phase's orders_nested cache, the JSON
    functions, the NULL type over the joins phase's cached lineitem, and
    the readers over files written here (hive-partitioned Parquet of the
    whole lineitem, decoded on the card; CSV, JSON lines, ORC and Avro),
    each query cold then once warm, in sessions in test mode."""
    import torch
    H = helpers()
    t0 = time.perf_counter()
    paths, docs, write_s = formats_files(table, orders, tmp_dir)
    files_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = formats_reference(table, orders, want)
    host_s = time.perf_counter() - t0
    queries = formats_queries(n1, h1.li, paths, docs)
    # the pipeline phase reads the hive layout and the CSV again
    RUN_NOTES["formats_files"] = {"paths": paths,
                                  "fm_hive_q1": ref["fm_hive_q1"],
                                  "fm_csv_q1": ref["fm_csv_q1"]}
    emit({"phase": "formats.setup", "files_s": files_s, "writes": write_s,
          "host_reference_s": host_s,
          "bytes": {k: sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(p) for f in fs)
                    if os.path.isdir(p) else os.path.getsize(p)
                    for k, p in paths.items()}})
    reset_launches()
    spy.take()
    problems = []
    for name, (session, fn) in queries.items():
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        # one warm run (the second was cut to pay for the pipeline phase),
        # none for the host-bound file queries (cut for the audit phase)
        warm = []
        if name not in FORMATS_COLD_ONLY:
            t0 = time.perf_counter()
            fn()
            warm = [time.perf_counter() - t0]
        runs = 1 + len(warm)
        good, how = validate_formats(name, got, ref[name])
        routes = {k: v // runs for k, v in spy.take().items()}
        launches = {k: (v - before[k]) // runs
                    for k, v in read_launches().items()}
        cpu_nodes = [type(m.plan).__name__ for m in session.last_meta.walk()
                     if not m.can_run_on_tpu]
        files = _scan_files(session)
        if not good:
            problems.append(f"{name} disagrees with the reference ({how})")
        if cpu_nodes != H.FORMATS_CPU_NODES.get(name, []):
            problems.append(f"{name} ran {cpu_nodes} on the CPU")
        if name == "fm_hive_pruned" and files != [2, 6]:
            problems.append(f"fm_hive_pruned kept {files} files")
        if name in ("fm_hive_q1", "fm_hive_pruned") \
                and launches["bitslice"] <= 0:
            problems.append(f"{name} decoded without bitslice: {launches}")
        if name == "fm_json_lines" and launches["murmur3_int32"] <= 0:
            problems.append(f"fm_json_lines hashed without murmur3: "
                            f"{launches}")
        emit({"phase": "formats.query", "query": name, "correct": good,
              "check": how, "cold_ms": cold * 1e3,
              "warm_ms": min(warm) * 1e3 if warm else None,
              "launches": launches,
              "routes": routes, "execs": _exec_names(session),
              "cpu_nodes": cpu_nodes, "files_kept_total": files,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    counts = read_launches()
    emit({"phase": "formats", "launches": counts, "correct": not problems,
          "problems": problems})
    if prof:
        prof.run("formats", {k: v[1] for k, v in queries.items()})
    if problems:
        raise AssertionError("; ".join(problems))
    if counts["segsum"] <= 0 or counts["bitslice"] <= 0:
        raise AssertionError(f"segsum and bitslice must run on the formats "
                             f"path: {counts}")
    return counts


#: formats queries run cold only: each run is 0.8-7.7 s of host work
#: (Python codecs, the decode source's host side), and the pipeline phase
#: times fm_hive_q1 warm again (cut to pay for the audit phase)
FORMATS_COLD_ONLY = ("fm_hive_q1", "fm_hive_pruned", "fm_avro",
                     "js_from_json", "js_path_rows", "js_to_json_fb")


# ---------------------------------------------------------------------------
# phase 17e: the scan pipelines
# ---------------------------------------------------------------------------

PIPE_OFF = {"spark.rapids.sql.pipeline.enabled": "false"}
#: the scans insert_pipelines wraps in a PipelineExec
PIPELINED_SCANS = ("ParquetScanExec", "EncodedParquetSourceExec",
                   "TextScanExec", "InMemoryScanExec", "ShuffleFileScanExec")
PIPE_FAULT = {"spark.rapids.debug.faults": "pipeline.producer:ioerror:1,1"}


def pipeline_queries(path):
    """name -> (extra conf, fn(session) -> answer, reference) over the
    files earlier phases wrote: the lineitem Parquet, the formats phase's
    hive layout and CSV, and sh_xproc's exchange files."""
    from spark_rapids_tpu_torch.shuffle import exchange_files as XF
    api = port_api()
    fm = RUN_NOTES["formats_files"]
    xroot, xref = RUN_NOTES["sh_xproc"]

    def parquet(cols, ref):
        return lambda s: port_queries(s.read_parquet(path,
                                                     columns=cols))[ref]()

    def shuffle_scan(s):
        d = XF.read_exchange(s, xroot).group_by(
            "l_returnflag", "l_linestatus").agg(
            api.F.sum("l_quantity").alias("q"),
            api.F.count().alias("n")).to_pydict()
        return {(f, st): (q, n) for f, st, q, n in zip(
            d["l_returnflag"], d["l_linestatus"], d["q"], d["n"])}

    return {
        "pq_q6": ({}, parquet(Q6_COLS, "q6"), "q6"),
        "pq_q6_host": (DECODE_OFF, parquet(Q6_COLS, "q6"), "q6"),
        "pq_repart_agg": ({}, parquet(["l_shipdate", "l_quantity"],
                                      "repart_agg"), "repart_agg"),
        "fm_hive_q1": ({}, lambda s: port_queries(s.read_parquet(
            fm["paths"]["hive"]))["q1"](), "fm_hive_q1"),
        "fm_csv_q1": ({}, lambda s: port_queries(s.read_csv(
            fm["paths"]["csv"]))["q1"](), "fm_csv_q1"),
        "sh_file_scan": ({}, shuffle_scan, "sh_xproc"),
    }


def _pipelines(session):
    """(scan classes under a PipelineExec, scan classes not under one,
    summed pipelineStallTime and pipelineProducerTime ms, depths) of the
    last query's tree."""
    nodes = list(session.last_exec.walk())
    pipes = [e for e in nodes if type(e).__name__ == "PipelineExec"]
    under = {id(p.children[0]) for p in pipes}
    snaps = [p.metrics.snapshot() for p in pipes]
    bare = [type(e).__name__ for e in nodes
            if type(e).__name__ in PIPELINED_SCANS and id(e) not in under]
    return (sorted(type(p.children[0]).__name__ for p in pipes),
            sorted(bare),
            sum(s.get("pipelineStallTime", 0) for s in snaps) / 1e6,
            sum(s.get("pipelineProducerTime", 0) for s in snaps) / 1e6,
            [s.get("pipelineDepth") for s in snaps])


def _busy_pool_threads():
    """Host-pool workers running engine code right now (an idle worker
    waits in the executor's queue)."""
    import threading
    frames = sys._current_frames()
    busy = []
    for t in threading.enumerate():
        if not t.name.startswith("rapids-host-pool"):
            continue
        f = frames.get(t.ident)
        while f is not None:
            if "spark_rapids_tpu_torch" in f.f_code.co_filename:
                busy.append(t.name)
                break
            f = f.f_back
    return busy


def _trace_events(trace_path) -> list:
    with open(trace_path) as f:
        return json.load(f)["traceEvents"]


def _stream_overlap(events, wall_ms):
    """From a Chrome trace's events of one run: device busy ms (the union
    of kernel, copy and memset intervals), the consumer's stream (the one
    with the most kernel time), host-to-device copies on it and on other
    streams, and the copies on other streams that overlap one of the
    consumer's kernels in time, with the overlapped ms."""
    import bisect
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    by_stream = {}
    for e in dev:
        if e["cat"] == "kernel":
            s = e.get("args", {}).get("stream")
            by_stream[s] = by_stream.get(s, 0.0) + e["dur"]
    consumer = max(by_stream, key=by_stream.get) if by_stream else None
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                     if e["cat"] == "kernel"
                     and e.get("args", {}).get("stream") == consumer)
    starts = [k[0] for k in kernels]
    h2d = [e for e in dev if e["cat"] == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    side = [e for e in h2d if e.get("args", {}).get("stream") != consumer]
    overlapping, overlap_us = 0, 0.0
    for e in side:
        a, b = e["ts"], e["ts"] + e["dur"]
        i = max(0, bisect.bisect_right(starts, a) - 1)
        hit = 0.0
        while i < len(kernels) and kernels[i][0] < b:
            hit += max(0.0, min(b, kernels[i][1]) - max(a, kernels[i][0]))
            i += 1
        if hit > 0:
            overlapping += 1
            overlap_us += hit
    busy, end = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"device_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1 - busy / 1e3 / wall_ms),
            "consumer_stream": consumer,
            "streams": sorted({e.get("args", {}).get("stream")
                               for e in dev}, key=str),
            "h2d_on_consumer_stream": len(h2d) - len(side),
            "h2d_on_side_streams": len(side),
            "h2d_overlapping_a_kernel": overlapping,
            "h2d_overlap_ms": overlap_us / 1e3}


def phase_pipeline(path, want, tmp_dir):
    """The scan pipelines (module docstring, phase 17e): each query warm
    with pipelining off, then on, each under torch.profiler's CUDA
    activity;
    bitwise equal answers that match pyarrow, the PipelineExec placement,
    a pipelined upload on a side stream overlapping a consumer kernel, a
    LIMIT that leaves no pool worker busy, and an injected producer
    death."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.runtime import faults
    from spark_rapids_tpu_torch.runtime.faults import InjectedFaultError
    t_phase = time.perf_counter()
    refs = {**want, **{k: v for k, v in RUN_NOTES["formats_files"].items()
                       if k != "paths"},
            "sh_xproc": RUN_NOTES["sh_xproc"][1]}
    reset_launches()
    problems = []
    total_overlaps = 0

    def run(s, fn, name):
        """One warm run under torch.profiler's CUDA activity (kernels and
        copies by stream; the host side is not traced): (answer, ms,
        launches, peak GB, the trace's stream reading)."""
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = fn(s)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v - before[k] for k, v in read_launches().items()}
        gb = torch.cuda.max_memory_allocated() / 2 ** 30
        trace_path = os.path.join(tmp_dir, f"pipeline_{name}.json")
        prof.export_chrome_trace(trace_path)
        streams = _stream_overlap(_trace_events(trace_path), ms)
        os.remove(trace_path)
        return got, ms, launches, gb, streams

    for name, (conf, fn, ref) in pipeline_queries(path).items():
        s_off = device_session({**conf, **PIPE_OFF})
        s_on = device_session(conf)
        off, off_ms, off_l, off_gb, off_st = run(s_off, fn, name)
        off_tree = _pipelines(s_off)
        on, on_ms, on_l, on_gb, on_st = run(s_on, fn, name)
        wrapped, bare, stall_ms, prod_ms, depths = _pipelines(s_on)
        total_overlaps += on_st["h2d_overlapping_a_kernel"]
        # sh_xproc's answer is exact; the others at bench.py's tolerances
        good = on == refs[ref] if ref == "sh_xproc" else validate(
            {"fm_hive_q1": "q1", "fm_csv_q1": "q1"}.get(ref, ref), on,
            refs[ref])
        if not good:
            problems.append(f"{name}: the pipelined answer disagrees with "
                            f"pyarrow")
        if on != off:
            problems.append(f"{name}: pipelined and synchronous answers "
                            f"differ")
        if on_l != off_l:
            problems.append(f"{name}: launches {on_l} pipelined, {off_l} "
                            f"synchronous")
        if not wrapped or bare or off_tree[0] \
                or set(depths) != {2}:
            problems.append(f"{name}: PipelineExec over {wrapped}, bare "
                            f"scans {bare}, depths {depths}, synchronous "
                            f"plan wraps {off_tree[0]}")
        emit({"phase": "pipeline.query", "query": name, "correct": good,
              "bitwise_equal": on == off, "warm_ms_on": on_ms,
              "warm_ms_off": off_ms, "on_over_off": on_ms / off_ms,
              "pipelineStallTime_ms": stall_ms,
              "pipelineProducerTime_ms": prod_ms,
              "pipelined_scans": wrapped, "on": on_st, "off": off_st,
              "peak_gb_on": on_gb, "peak_gb_off": off_gb,
              "launches": on_l})
    if total_overlaps <= 0:
        problems.append("no pipelined host-to-device copy on a side stream "
                        "overlapped a consumer kernel")

    # a LIMIT over the pipelined device-decode scan: it stops early and
    # leaves no pool worker running engine code
    s = device_session()
    api = port_api()
    t0 = time.perf_counter()
    rows = s.read_parquet(path, columns=Q6_COLS).filter(
        api.col("l_quantity") < api.lit(24.0)).limit(1000).collect().num_rows
    limit_ms = (time.perf_counter() - t0) * 1e3
    busy = _busy_pool_threads()
    pipes = [e.metrics.snapshot() for e in s.last_exec.walk()
             if type(e).__name__ == "PipelineExec"]
    batches = sum(p.get("numOutputBatches", 0) for p in pipes)
    if rows != 1000 or busy or not pipes or batches >= 29:
        problems.append(f"pipe_limit: {rows} rows, busy pool threads "
                        f"{busy}, {batches} batches over {len(pipes)} "
                        f"boundaries")
    emit({"phase": "pipeline.limit", "rows": rows, "ms": limit_ms,
          "busy_pool_threads": busy, "batches_through_boundary": batches})

    # an injected producer death fails the query with the injected error
    s = device_session(PIPE_FAULT)
    err = None
    try:
        port_queries(s.read_parquet(path, columns=Q6_COLS))["q6"]()
    except InjectedFaultError as e:
        err = e
    faults.configure("")
    busy = _busy_pool_threads()
    if err is None or s.last_action_status != ("failed", None) or busy:
        problems.append(f"pipe_fault: raised {err!r}, status "
                        f"{s.last_action_status}, busy {busy}")
    emit({"phase": "pipeline.fault", "spec": PIPE_FAULT,
          "raised": repr(err), "status": s.last_action_status,
          "busy_pool_threads": busy})
    counts = read_launches()
    emit({"phase": "pipeline", "launches": counts, "correct": not problems,
          "problems": problems, "h2d_overlapping_total": total_overlaps,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 17b: the serialized shuffle, the writers and the table formats
# ---------------------------------------------------------------------------

SERIALIZED = {"spark.rapids.shuffle.mode": "SERIALIZED"}
#: the joins phase's 8-partition session: q3join_shuffled stays shuffled
SHUFFLED_JOIN = {"spark.rapids.sql.join.broadcastRowThreshold": 0,
                 "spark.rapids.sql.adaptive.broadcastThresholdBytes": 0}
SH_DISK_BUDGET = 64 << 20
SH_XPROC_ROWS = 5_000_000
SH_WRITE_ROWS = 5_000_000
SH_UPSERTS = 300_000
#: the Hive text table's lines (1M until the audit phase; cut to pay for
#: it)
SH_HIVE_ROWS = 250_000

#: sh_xproc's writer: a process of the port alone, which must import
#: neither jax nor the JAX package
XPROC_WRITER = r"""
import json, sys, time
t0 = time.perf_counter()
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.shuffle.exchange_files import write_exchange
src, root = sys.argv[1:3]
s = TorchSession({"spark.rapids.sql.test.enabled": "true"})
df = s.read_parquet(src, columns=["l_orderkey", "l_returnflag",
                                  "l_linestatus", "l_quantity"])
write_exchange(df, root, ["l_orderkey"], 8)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu"))
print(json.dumps({"imported": bad, "seconds": time.perf_counter() - t0}))
sys.exit(1 if bad else 0)
"""


def shuffle_totals(session):
    """The last query's serialized exchanges: their count, bytes written
    and spilled, and blobs."""
    from spark_rapids_tpu_torch.exec import nodes as X
    exs = [e for e in session.last_exec.walk()
           if isinstance(e, X.ShuffleExchangeExec)]
    stores = [e._store for e in exs if e._store is not None]
    return {"exchanges": len(exs), "serialized": len(stores),
            "bytes_written": sum(e.metrics["shuffleBytesWritten"]
                                 for e in exs),
            "bytes_spilled": sum(e.metrics["shuffleBytesSpilled"]
                                 for e in exs),
            "blobs": sum(st.num_blobs(p) for st in stores
                         for p in range(st.n_partitions))}


def shuffle_queries(h8):
    """name -> (extra conf, fn(li, od)): the three sh_* shapes over the
    joins phase's 8-partition caches."""
    H, api = helpers(), port_api()

    def q72(li, od):
        d = H.q72shfl_repart(api, li).to_pydict()
        return {k: (s, c) for k, s, c in zip(d["k"], d["s"], d["c"])}

    def rep(li, od):
        d = H.repart_agg(api, li).to_pydict()
        return {k: (s, c) for k, s, c in zip(d["l_shipdate"], d["s"],
                                              d["c"])}

    def q3(li, od):
        d = H.q3join(api, li, od).to_pydict()
        return dict(zip(d["l_orderkey"], d["rev"]))

    return {"sh_q72shfl": ({}, q72), "sh_repart_agg": ({}, rep),
            "sh_q3join_shuffled": (SHUFFLED_JOIN, q3)}


def same_answer(got, want) -> bool:
    """Group by group: sums within 1e-9 relative, counts exact."""
    if set(got) != set(want):
        return False
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple):
            if not (_close(g[0], w[0], 1e-9) and g[1] == w[1]):
                return False
        elif not _close(g, w, 1e-9):
            return False
    return True


def phase_shuffle(table, orders, want, h8, tmp_dir, spy):
    """The serialized shuffle (sh_*: each query under MULTITHREADED, then
    SERIALIZED at the JAX package's defaults; a 64 MiB host budget; a
    corrupt read; a cross-process exchange), the writers (wr_parquet_q1)
    and the table formats (tb_delta_merge: Delta with MERGE, Iceberg,
    Hive text), each checked against numpy, pyarrow or the same query's
    MULTITHREADED answer."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch
    from spark_rapids_tpu_torch import config as TC
    from spark_rapids_tpu_torch.shuffle import exchange_files as XF
    from spark_rapids_tpu_torch.shuffle import serde
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H, api = helpers(), port_api()
    t_phase = time.perf_counter()
    codec = serde.resolve_codec(TC.RapidsConf().get(TC.SHUFFLE_COMPRESSION))
    emit({"phase": "shuffle.setup", "codec": codec,
          "native_packer": serde.kudo_lib()._name,
          "host_spill_budget": TC.RapidsConf().get(TC.SHUFFLE_HOST_BUDGET)})
    reset_launches()
    spy.take()
    problems = []

    def run(session, fn, runs=3):
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        answers, secs = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            answers.append(fn())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = {k: (v - before[k]) // runs
                    for k, v in read_launches().items()}
        return answers, {
            "cold_ms": secs[0] * 1e3,
            "warm_ms": min(secs[1:]) * 1e3 if runs > 1 else None,
            "launches": launches,
            "routes": {k: v // runs for k, v in spy.take().items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "shuffle": shuffle_totals(session),
            "task_metrics": session.last_task_metrics(),
            "status": session.last_action_status}

    refs = {"sh_q72shfl": want["q72shfl_groups"],
            "sh_repart_agg": want["repart_agg"]}
    mt_answers = {}
    for name, (conf, fn) in shuffle_queries(h8).items():
        lines = {}
        for mode in ("MULTITHREADED", "SERIALIZED"):
            s = device_session({**conf, "spark.rapids.shuffle.mode": mode})
            li, od = DataFrame(h8.li.plan, s), DataFrame(h8.od.plan, s)
            answers, lines[mode] = run(s, lambda: fn(li, od), runs=RUNS)
            if not all(same_answer(a, answers[0]) for a in answers[1:]):
                problems.append(f"{name} {mode}: runs differ")
            if mode == "MULTITHREADED":
                mt = mt_answers[name] = answers[0]
            got = answers[0]
        mt_l, ser_l = lines["MULTITHREADED"], lines["SERIALIZED"]
        good = same_answer(got, mt) and (name not in refs
                                         or validate(name, got, refs[name]))
        b12 = ("murmur3_int32", "segsum")
        if not good:
            problems.append(f"{name}: SERIALIZED disagrees with "
                            f"MULTITHREADED or the reference")
        if any(ser_l["launches"][k] != mt_l["launches"][k] for k in b12):
            problems.append(f"{name}: launches {ser_l['launches']} under "
                            f"SERIALIZED, {mt_l['launches']} under "
                            f"MULTITHREADED")
        if not (ser_l["shuffle"]["serialized"] > 0
                and ser_l["shuffle"]["bytes_written"] > 0
                and mt_l["shuffle"]["serialized"] == 0):
            problems.append(f"{name}: shuffle {ser_l['shuffle']} "
                            f"(MULTITHREADED {mt_l['shuffle']})")
        emit({"phase": "shuffle.query", "query": name, "correct": good,
              "bitwise_equal": got == mt, "codec": codec,
              "serialized": ser_l, "multithreaded": mt_l,
              "warm_ratio": ser_l["warm_ms"] / mt_l["warm_ms"]})

    # sh_disk: repart_agg under a 64 MiB host budget, its blobs paged out
    s = device_session({**SERIALIZED, "spark.rapids.shuffle.hostSpillBudget":
                        SH_DISK_BUDGET})
    rep = shuffle_queries(h8)["sh_repart_agg"][1]
    li8 = DataFrame(h8.li.plan, s)
    answers, line = run(s, lambda: rep(li8, None), runs=2)
    good = same_answer(answers[0], mt_answers["sh_repart_agg"])
    if not good or line["shuffle"]["bytes_spilled"] <= 0:
        problems.append(f"sh_disk: correct {good}, {line['shuffle']}")
    emit({"phase": "shuffle.query", "query": "sh_disk", "correct": good,
          "host_spill_budget": SH_DISK_BUDGET, **line})

    # sh_corrupt: one corrupted blob read, re-fetched from the store
    s = device_session({**SERIALIZED, "spark.rapids.debug.faults":
                        "shuffle.read:corrupt:1"})
    li8 = DataFrame(h8.li.plan, s)
    answers, line = run(s, lambda: rep(li8, None), runs=1)
    retries = line["task_metrics"].get("shuffleCorruptionRetries")
    good = same_answer(answers[0], mt_answers["sh_repart_agg"])
    if not good or retries != 1 or line["status"] != ("ok", None):
        problems.append(f"sh_corrupt: correct {good}, retries {retries}, "
                        f"status {line['status']}")
    emit({"phase": "shuffle.query", "query": "sh_corrupt", "correct": good,
          "corruption_retries": retries, **line})

    # sh_xproc: a process of the port writes the exchange files of the
    # first 5M lines; this one mounts them
    head = table.slice(0, SH_XPROC_ROWS)
    src = os.path.join(tmp_dir, "sh_xproc_src.parquet")
    root = os.path.join(tmp_dir, "sh_xproc")
    pq.write_table(head, src, **PARQUET_WRITE)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", XPROC_WRITER, src, root],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    writer_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sh_xproc's writer failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    writer = json.loads(proc.stdout.strip().splitlines()[-1])
    s = device_session()

    def xproc():
        d = XF.read_exchange(s, root).group_by(
            "l_returnflag", "l_linestatus").agg(
            api.F.sum("l_quantity").alias("q"),
            api.F.count().alias("n")).to_pydict()
        return {(f, st): (q, n) for f, st, q, n in zip(
            d["l_returnflag"], d["l_linestatus"], d["q"], d["n"])}
    answers, line = run(s, xproc, runs=2)
    g = head.group_by(["l_returnflag", "l_linestatus"]).aggregate(
        [("l_quantity", "sum"), ("l_quantity", "count")])
    ref = {(f, st): (q, n) for f, st, q, n in zip(*[
        g[c].to_pylist() for c in ("l_returnflag", "l_linestatus",
                                   "l_quantity_sum", "l_quantity_count")])}
    t0 = time.perf_counter()
    misplaced = rows = 0
    for r in range(8):
        for b in XF.read_partition_batches(root, r):
            k = b.columns[0].data[: b.num_rows].numpy()
            pid = np.mod(np_murmur3_long(k, _U32(42)).view(np.int32), 8)
            misplaced += int((pid != r).sum())
            rows += b.num_rows
    copart_s = time.perf_counter() - t0
    good = answers[0] == ref and misplaced == 0 and rows == SH_XPROC_ROWS
    RUN_NOTES["sh_xproc"] = (root, ref)  # the pipeline phase mounts it
    if not good:
        problems.append(f"sh_xproc: correct {answers[0] == ref}, "
                        f"{misplaced} misplaced of {rows} rows")
    emit({"phase": "shuffle.query", "query": "sh_xproc", "correct": good,
          "writer": writer, "writer_wall_s": writer_s,
          "files_bytes": sum(os.path.getsize(os.path.join(root, f))
                             for f in os.listdir(root)),
          "copartition_check_s": copart_s, "misplaced": misplaced, **line})

    # wr_parquet_q1: the first 5M lines written partitioned by the flags,
    # then q1 over the files through the device-decode source (B3)
    head = table.slice(0, SH_WRITE_ROWS)
    s = device_session()
    out = os.path.join(tmp_dir, "wr_lineitem")
    w = s.create_dataframe(head, num_partitions=4).write.partition_by(
        "l_returnflag", "l_linestatus")
    before = read_launches()
    t0 = time.perf_counter()
    w.parquet(out)
    write_s = time.perf_counter() - t0
    write_launches = {k: v - before[k] for k, v in read_launches().items()}
    q1 = port_queries(s.read_parquet(out))["q1"]
    answers, line = run(s, q1, runs=2)
    good = validate("q1", answers[0], q1_reference(head))
    st = w.last_write_stats
    if not good or (st["numFiles"], st["numOutputRows"], st["numParts"]) \
            != (24, SH_WRITE_ROWS, 6) or line["launches"]["bitslice"] <= 0:
        problems.append(f"wr_parquet_q1: correct {good}, stats {st}, "
                        f"launches {line['launches']}")
    emit({"phase": "shuffle.query", "query": "wr_parquet_q1",
          "correct": good, "write_s": write_s, "write_stats": st,
          "write_launches": write_launches, **line})

    # tb_delta_merge: orders as a Delta table, 300,000 upserts merged in
    from spark_rapids_tpu_torch.sql.delta import DeltaTable
    from spark_rapids_tpu_torch.sql.hive import HiveTable
    from spark_rapids_tpu_torch.sql.iceberg import IcebergTable
    s = device_session()
    col = api.col
    ups = H.orders_upserts(orders, SH_UPSERTS)
    times = {}
    before = read_launches()
    t0 = time.perf_counter()
    dpath = os.path.join(tmp_dir, "delta_orders")
    dt = DeltaTable.create(s, dpath, s.create_dataframe(orders))
    times["create_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (dt.merge(s.create_dataframe(ups), on=["o_orderkey"])
       .when_matched_update({"o_orderdate": col("__src_o_orderdate"),
                             "o_custkey": col("__src_o_custkey")})
       .when_not_matched_insert().execute())
    times["merge_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = DeltaTable.for_path(s, dpath).to_df().collect().sort_by(
        "o_orderkey")
    times["read_s"] = time.perf_counter() - t0
    keys, date, cust = H.upsert_reference(orders, ups)
    delta_ok = (np.array_equal(back["o_orderkey"].to_numpy(), keys)
                and np.array_equal(back["o_orderdate"].to_numpy(), date)
                and np.array_equal(back["o_custkey"].to_numpy(), cust)
                and [h["operation"] for h in dt.history()]
                == ["MERGE", "CREATE TABLE AS SELECT"])
    # Iceberg: two appends of halves of the orders, a snapshot read
    t0 = time.perf_counter()
    half = orders.num_rows // 2
    it = IcebergTable.create(s, os.path.join(tmp_dir, "ice_orders"),
                             s.create_dataframe(orders.slice(0, half)))
    s0 = it.snapshots()[0]["snapshot_id"]
    it.append(s.create_dataframe(orders.slice(half)))
    ice = (it.to_df(snapshot_id=s0).count(), it.to_df().count(),
           it.to_df().agg(api.F.sum("o_custkey").alias("c"))
           .to_pydict()["c"][0])
    times["iceberg_s"] = time.perf_counter() - t0
    ice_ok = ice == (half, orders.num_rows,
                     int(orders["o_custkey"].to_numpy().sum()))
    # Hive text: SH_HIVE_ROWS lines, partitioned by the return flag
    t0 = time.perf_counter()
    lines = table.slice(0, SH_HIVE_ROWS).select(
        ["l_orderkey", "l_quantity", "l_returnflag"])
    schema = pa.schema([("l_orderkey", pa.int64()),
                        ("l_quantity", pa.float64()),
                        ("l_returnflag", pa.string())])
    hpath = os.path.join(tmp_dir, "hive_lineitem")
    HiveTable(s, hpath, schema, partition_cols=["l_returnflag"]).insert(
        s.create_dataframe(lines))
    times["hive_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = HiveTable(s, hpath, schema, partition_cols=["l_returnflag"]) \
        .to_df().group_by("l_returnflag").agg(
            api.F.sum("l_quantity").alias("q"),
            api.F.sum("l_orderkey").alias("k"),
            api.F.count().alias("n")).to_pydict()
    times["hive_read_s"] = time.perf_counter() - t0
    hive = {f: (q, k, n) for f, q, k, n in zip(d["l_returnflag"], d["q"],
                                                d["k"], d["n"])}
    flags = lines["l_returnflag"].to_numpy(False)
    qty, okey = lines["l_quantity"].to_numpy(), lines["l_orderkey"].to_numpy()
    hive_ref = {f: (float(qty[flags == f].sum()),
                    int(okey[flags == f].sum()), int((flags == f).sum()))
                for f in np.unique(flags)}
    hive_ok = hive == hive_ref
    tb_launches = {k: v - before[k] for k, v in read_launches().items()}
    spy.take()
    good = delta_ok and ice_ok and hive_ok
    if not good:
        problems.append(f"tb_delta_merge: delta {delta_ok}, iceberg "
                        f"{ice_ok} {ice}, hive {hive_ok}")
    emit({"phase": "shuffle.query", "query": "tb_delta_merge",
          "correct": good, "delta_rows": back.num_rows,
          "delta_files": len(DeltaTable.for_path(s, dpath).log.snapshot()
                             .files), "upserts": SH_UPSERTS,
          "iceberg": ice, "hive": hive, "times": times,
          "launches": tb_launches})
    counts = read_launches()
    emit({"phase": "shuffle", "launches": counts, "correct": not problems,
          "problems": problems, "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    if min(counts["murmur3_int32"], counts["segsum"],
           counts["bitslice"]) <= 0:
        raise AssertionError(f"murmur3, segsum and bitslice must run on "
                             f"the shuffle path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 17c: the UDF tier
# ---------------------------------------------------------------------------

COMPILER_ON = {"spark.rapids.sql.udfCompiler.enabled": "true"}
POOL_OFF = {"spark.rapids.sql.python.workerPool.enabled": "false"}


def udf_reference(table):
    """numpy's answers of udf_q72_compiled and udf_repart_torch: {key:
    (sum, count)}."""
    ok = table["l_orderkey"].to_numpy()
    price = table["l_extendedprice"].to_numpy()
    disc = table["l_discount"].to_numpy()
    qty = table["l_quantity"].to_numpy()
    k = np.mod(ok, 100_000)
    charge = price * (1.0 - disc) * (1.0 + np.mod(ok, 9) / 100.0)
    s = np.bincount(k, weights=charge, minlength=100_000)
    c = np.bincount(k, minlength=100_000)
    compiled = {int(i): (float(s[i]), int(c[i])) for i in np.nonzero(c)[0]}
    cheap = disc < 0.095
    vs = np.bincount(k[cheap], weights=2.0 * qty[cheap] - 1.0,
                     minlength=100_000)
    vc = np.bincount(k[cheap], minlength=100_000)
    repart = {int(i): (float(vs[i]) if vc[i] else None, int(vc[i]))
              for i in np.nonzero(c)[0]}
    return {"udf_q72_compiled": compiled, "udf_repart_torch": repart}


def _groups(t, key, names):
    d = t.to_pydict()
    return {k: tuple(d[n][i] for n in names) for i, k in enumerate(d[key])}


def _cpu_nodes(session):
    return [type(m.plan).__name__ for m in session.last_meta.walk()
            if not m.can_run_on_tpu]


#: udf_row_pool's and udf_compiled_vs_row's lines (1M, the helpers'
#: UDF_ROW_LINES, until the audit phase; cut to pay for it)
UDF_SMOKE_ROW_LINES = 500_000


def phase_udf(table, h1, h8, spy):
    """The UDF tier (module docstring, phase 17c): a compiled row UDF, a
    columnar torch UDF with its own validity behind a hash exchange, an
    opaque row UDF on the CPU with the worker pool on and off, and one
    lambda compiled and on the row tier."""
    import torch
    from spark_rapids_tpu_torch import config as TC
    from spark_rapids_tpu_torch.exec.nodes import CpuFallbackExec
    from spark_rapids_tpu_torch.runtime import pyworker
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H, api = helpers(), port_api()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    want = udf_reference(table)
    small = table.slice(0, UDF_SMOKE_ROW_LINES)
    row_want = H.udf_row_flags_answer(small)
    emit({"phase": "udf.setup", "numpy_s": time.perf_counter() - t0})
    reset_launches()
    spy.take()
    problems = []

    def run(name, session, build, runs=2, note=None):
        """build() makes the query (after the session's conf became the
        thread's, which a udf's compile decision reads); cold then warm
        runs; one udf.query line."""
        TC.set_session_conf(session.conf)
        df = build()
        before = read_launches()
        answers, secs = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            answers.append(df.collect())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        line = {"phase": "udf.query", "query": name,
                "cold_ms": secs[0] * 1e3,
                "warm_ms": min(secs[1:]) * 1e3 if runs > 1 else None,
                "launches_per_run": {k: (v - before[k]) // runs
                                     for k, v in read_launches().items()},
                "routes": {k: v // runs for k, v in spy.take().items()},
                "cpu_nodes": _cpu_nodes(session),
                "execs": _exec_names(session)}
        line.update(note or {})
        return answers, line

    # udf_q72_compiled: the compiled charge, grouped like q72shfl
    s = device_session(COMPILER_ON)
    answers, line = run("udf_q72_compiled", s, lambda: H.udf_q72_compiled(
        api, DataFrame(h1.li.plan, s)))
    got = [_groups(a, "k", ("s", "c")) for a in answers]
    good = all(validate("udf_q72_compiled", g, want["udf_q72_compiled"])
               for g in got)
    if not good:
        problems.append("udf_q72_compiled disagrees with numpy")
    if line["cpu_nodes"] or line["launches_per_run"]["segsum"] <= 0:
        problems.append(f"udf_q72_compiled: CPU nodes {line['cpu_nodes']}, "
                        f"launches {line['launches_per_run']}")
    emit({**line, "correct": good, "groups": len(got[0])})

    # udf_repart_torch: the columnar UDF over the 8-partition cache
    s = device_session()
    answers, line = run("udf_repart_torch", s, lambda: H.udf_repart_columnar(
        api, DataFrame(h8.li.plan, s)))
    got = [_groups(a, "k", ("s", "c")) for a in answers]
    good = all(g == want["udf_repart_torch"] for g in got)
    lr = line["launches_per_run"]
    if not good:
        problems.append("udf_repart_torch disagrees with numpy")
    if line["cpu_nodes"] or lr["murmur3_int32"] <= 0 or lr["segsum"] <= 0:
        problems.append(f"udf_repart_torch: CPU nodes {line['cpu_nodes']}, "
                        f"launches {lr}")
    emit({**line, "correct": good, "exact": good})

    # udf_row_pool: the opaque row UDF in a CPU Project, pool on and off
    pyworker.shutdown_pool()
    s_on = device_session(allowed=H.UDF_FALLBACK_NODE)
    cached = s_on.create_dataframe(small).cache()
    cached.count()
    s_off = device_session(POOL_OFF, allowed=H.UDF_FALLBACK_NODE)
    pool = {}
    try:
        for mode, sess in (("off", s_off), ("on", s_on)):
            answers, line = run(f"udf_row_pool_{mode}", sess,
                                lambda: H.udf_row_flags(
                                    api, DataFrame(cached.plan, sess)))
            [fb] = [e for e in sess.last_exec.walk()
                    if isinstance(e, CpuFallbackExec)]
            workers = pyworker._POOL_SIZE if pyworker._POOL is not None \
                else 0
            got = [_groups(a, "t", ("q", "n")) for a in answers]
            good = all(g == row_want for g in got)
            # each collect converts a new operator tree: the fallback's
            # transfers are the last run's
            pool[mode] = {"workers": workers,
                          "cpu_step_ms": fb.transfers["cpu_ms"],
                          "cold_ms": line["cold_ms"],
                          "warm_ms": line["warm_ms"]}
            if not good:
                problems.append(f"udf_row_pool_{mode} disagrees with the "
                                f"Python loop")
            if line["cpu_nodes"] != [H.UDF_FALLBACK_NODE]:
                problems.append(f"udf_row_pool_{mode} placed "
                                f"{line['cpu_nodes']} on the CPU")
            emit({**line, "correct": good, "workers": workers,
                  # the last run's download, CPU and upload ms
                  "transfers_last_run": {k: v for k, v in
                                         fb.transfers.items()
                                         if k.endswith("_ms")},
                  "lines": small.num_rows})
    finally:
        pyworker.shutdown_pool()
    if pool["on"]["workers"] <= 1 or pool["off"]["workers"] != 0:
        problems.append(f"udf_row_pool: workers {pool}")

    # udf_compiled_vs_row: one lambda compiled, and on the row tier
    answers = {}
    for mode, sess in (("compiled", device_session(COMPILER_ON)),
                       ("row", device_session(
                           POOL_OFF, allowed=H.UDF_FALLBACK_NODE))):
        got, line = run(f"udf_compiled_vs_row_{mode}", sess,
                        lambda: H.udf_late_qty(
                            api, DataFrame(cached.plan, sess)), runs=2)
        answers[mode] = _groups(got[0], "l_returnflag", ("s", "n"))
        want_cpu = [] if mode == "compiled" else [H.UDF_FALLBACK_NODE]
        if line["cpu_nodes"] != want_cpu:
            problems.append(f"udf_compiled_vs_row_{mode} placed "
                            f"{line['cpu_nodes']} on the CPU")
        emit(line)
    good = answers["compiled"] == answers["row"]
    if not good:
        problems.append(f"udf_compiled_vs_row: {answers}")
    emit({"phase": "udf.compiled_vs_row", "equal": good,
          "answer": {str(k): v for k, v in answers["compiled"].items()}})
    del cached
    counts = read_launches()
    emit({"phase": "udf", "launches": counts, "correct": not problems,
          "problems": problems, "pool": pool,
          "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    if min(counts["murmur3_int32"], counts["segsum"]) <= 0:
        raise AssertionError(f"murmur3 and segsum must run on the udf "
                             f"path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 17d: the query trace and the per-operator metrics
# ---------------------------------------------------------------------------

def profiler_report():
    """tools/profiler_report.py (the standard library only)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    import profiler_report as PR
    return PR


def trace_check(PR, session, name, want_instants=()):
    """The action's artifacts: Chrome trace JSON, every span total within
    1% of its last_metrics() timer, every timer with its spans (but the
    waiting and overlapped ones, the pipeline boundaries' stall and
    producer times, which no span feeds), and the instants asked for.
    Returns (summary, problems)."""
    from spark_rapids_tpu_torch.runtime.metrics import WAIT_TIME_METRICS
    problems = []
    art = PR.load_artifacts(session.last_trace_paths["trace"])
    rows = PR.analyze(art)["reconciliation"]
    timers = {f"{k.split('#')[0]}.{m}" for k, snap in
              session.last_metrics().items() for m, v in snap.items()
              if m.endswith("Time") and v and m not in WAIT_TIME_METRICS}
    worst = max((r["delta_pct"] for r in rows), default=None)
    if not rows or worst >= 1.0:
        problems.append(f"{name}: reconciliation {rows}")
    if timers != {r["name"] for r in rows}:
        problems.append(f"{name}: timers {sorted(timers)} but spans of "
                        f"{sorted(r['name'] for r in rows)}")
    names = {e["name"] for e in art["events"]}
    missing = [i for i in want_instants if i not in names]
    if missing:
        problems.append(f"{name}: no {missing} instants")
    spans = [e for e in art["events"] if e["ph"] == "X"]
    return {"events": len(art["events"]), "spans": len(spans),
            "span_ms_by_name": {r["name"]: r["span_us"] / 1e3
                                for r in rows},
            "tasks": len(art["tasks"]), "worst_delta_pct": worst,
            "reconciled": len(rows),
            "instants": sorted({e["name"] for e in art["events"]
                                if e["ph"] == "i"}),
            "status": art["query"]["status"]}, problems


def phase_trace(want, h1, h8, pq_path, tmp_dir, spy):
    """Tracing (module docstring, phase 17d): q1, q3join_shuffled, pq_q6
    and the paged q1, each untraced then traced."""
    from types import SimpleNamespace

    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    PR = profiler_report()
    t_phase = time.perf_counter()
    trace_dir = os.path.join(tmp_dir, "trace")
    traced = {"spark.rapids.sql.trace.enabled": "true",
              "spark.rapids.sql.trace.path": trace_dir}
    li8_bytes = sum(sb.size for part in h8.li.plan.materialized
                    for sb in part)
    paged = {"spark.rapids.memory.spillDir": os.path.join(tmp_dir, "spill"),
             "spark.rapids.memory.tpu.budgetBytes": li8_bytes // 2}
    jwant = RUN_NOTES["q3join_shuffled_want"]

    def q1(s):
        return port_queries(DataFrame(h1.li.plan, s))["q1"]

    def q3(s):
        h8s = SimpleNamespace(s=s, li=DataFrame(h8.li.plan, s),
                              od=DataFrame(h8.od.plan, s))
        return joins_queries(h1, h8s)["q3join_shuffled"][1]

    def pq6(s):
        return port_queries(s.read_parquet(pq_path, columns=Q6_COLS))["q6"]

    def paged_q1(s):
        return port_queries(DataFrame(h8.li.plan, s))["q1"]

    queries = {
        "tr_q1": ({}, q1, lambda g: validate("q1", g, want["q1"]),
                  "path_q1_warm_ms", ()),
        "tr_q3join_shuffled": (SHUFFLED_JOIN, q3, lambda g: validate_joins(
            "q3join_shuffled", g, jwant), "q3join_shuffled_warm_ms", ()),
        "tr_pq_q6": ({}, pq6, lambda g: _close(g, want["q6"]),
                     "pq_q6_warm_ms", ()),
        "tr_paged_q1": (paged, paged_q1, lambda g: validate(
            "q1", g, want["q1"]), None,
            ("semaphoreAcquire", "semaphoreRelease", "spillToHost")),
    }
    reset_launches()
    spy.take()
    problems = []
    for name, (conf, make, check, note, instants) in queries.items():
        line = {"phase": "trace.query", "query": name,
                "earlier_warm_ms": RUN_NOTES.get(note) if note else None}
        for mode, extra in (("off", {}), ("on", traced)):
            s = device_session({**conf, **extra})
            fn = make(s)
            before = read_launches()
            secs, good = [], True
            for _ in range(RUNS):
                t0 = time.perf_counter()
                good &= bool(check(fn()))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            line[f"warm_ms_trace_{mode}"] = min(secs[1:]) * 1e3
            line[f"cold_ms_trace_{mode}"] = secs[0] * 1e3
            line[f"launches_per_run_{mode}"] = {
                k: (v - before[k]) // RUNS
                for k, v in read_launches().items()}
            if not good:
                problems.append(f"{name} (tracing {mode}) disagrees")
            if mode == "off" and s.last_trace_paths is not None:
                problems.append(f"{name}: untraced run wrote a trace")
        summary, bad = trace_check(PR, s, name, instants)
        problems.extend(bad)
        line["trace"] = summary
        line["routes"] = {k: v // (2 * RUNS)
                          for k, v in spy.take().items()}
        line["metrics"] = s.last_metrics()
        line["trace_overhead"] = line["warm_ms_trace_on"] \
            / line["warm_ms_trace_off"]
        if line["launches_per_run_on"] != line["launches_per_run_off"]:
            problems.append(f"{name}: launches differ with tracing on")
        emit(line)
    if read_launches()["bitslice"] <= 0:
        problems.append("tr_pq_q6 launched no bitslice")

    # one traced query under torch.profiler: the exec spans are ranges
    s = device_session({**SHUFFLED_JOIN, **traced})
    fn = q3(s)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges = {e.key: e.count for e in prof.key_averages()
              if e.key.endswith("Time") and "Exec." in e.key}
    span_names = {f"{k.split('#')[0]}.{m}" for k, snap in
                  s.last_metrics().items() for m, v in snap.items()
                  if m.endswith("Time") and v}
    if not span_names or not span_names <= set(ranges):
        problems.append(f"profiler ranges {ranges}, exec spans "
                        f"{sorted(span_names)}")
    emit({"phase": "trace.profiler", "ranges": ranges,
          "exec_spans": sorted(span_names)})
    counts = read_launches()
    emit({"phase": "trace", "launches": counts, "correct": not problems,
          "problems": problems, "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 17f: the live observability layer, on against off
# ---------------------------------------------------------------------------

#: the live layer switched off: this phase's plain version
OBS_OFF = {"spark.rapids.obs.enabled": "false",
           "spark.rapids.obs.flight.enabled": "false",
           "spark.rapids.obs.sampler.enabled": "false"}
#: the host syncs a run makes, from the CUDA runtime calls torch.profiler
#: records on every thread
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _obs_teardown():
    """The live layer is process-wide: drop it (registry, endpoint,
    sampler thread, live registry, flight recorder), so the next session
    installs it from its own conf."""
    from spark_rapids_tpu_torch.runtime import obs
    from spark_rapids_tpu_torch.runtime.obs import flight
    obs.shutdown_for_tests()
    flight.uninstall_for_tests()


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _http_json(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
            return r.status, body
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Scraper:
    """A thread that GETs the endpoint's routes every 50 ms while a run
    goes, keeping each answer's parsed body (the /metrics text is held to
    the exposition format)."""

    def __init__(self, port, routes):
        self.base = f"http://127.0.0.1:{port}"
        self.routes = routes
        self.seen = {r: [] for r in routes}
        self.errors = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, name="smoke-scraper",
                                   daemon=True)

    def _loop(self):
        import re
        line = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
                          r"[-+]?(\d+\.?\d*([eE][-+]?\d+)?|NaN|nan|"
                          r"[Ii]nf)$")
        while not self._stop.is_set():
            for r in self.routes:
                try:
                    code, body = _http_json(self.base + r)
                    if r == "/metrics":
                        bad = [x for x in body.splitlines()
                               if x and not x.startswith("#")
                               and not line.match(x)]
                        if code != 200 or bad:
                            self.errors.append(f"/metrics {code} {bad[:2]}")
                        self.seen[r].append(len(body))
                    else:
                        self.seen[r].append((time.perf_counter(), code,
                                             json.loads(body)))
                except Exception as e:  # noqa: BLE001 - recorded, checked
                    self.errors.append(f"{r}: {e!r}")
            self._stop.wait(0.05)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(10)
        return False


def _copies_and_syncs(events):
    """(device-to-host copies the card recorded, the largest one's bytes,
    copy calls the host made in any direction, host syncs, copy calls
    with no record on the card) of a profiled run's trace events. The
    profiler can drop the card's copy records of a run while it keeps the
    host's calls: the last count says how many (by the correlation id a
    call shares with its copy)."""
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    d2h_bytes = [int(e.get("args", {}).get("bytes", 0)) for e in copies
                 if "DtoH" in e.get("name", "")]
    # the runtime's and the lower API's calls ("cuda_runtime" and the
    # other "cuda_" categories of the trace)
    host = [e for e in events if str(e.get("cat", "")).startswith("cuda_")]
    names = [e.get("name", "") for e in host]
    recorded = {e.get("args", {}).get("correlation") for e in copies}
    dropped = sum(1 for e in host if "emcpy" in e.get("name", "")
                  and e.get("args", {}).get("correlation") not in recorded)
    return (len(d2h_bytes), max(d2h_bytes, default=0),
            sum(1 for n in names if "emcpy" in n),
            sum(1 for n in names if n in SYNC_CALLS), dropped)


def profiled_run(fn, trace_path, tries: int = 3):
    """One run of fn under torch.profiler's CUDA activity, repeated (up to
    ``tries`` runs in all) while the profiler dropped some of its copy
    records; returns fn's result and the counts of the run that dropped
    the fewest: device-to-host copy records (``d2h``) and the largest's
    bytes, copy calls in any direction, cuda*Synchronize calls, copy
    calls with no record (``dropped``), device busy ms and idle share,
    wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lost, best = [], None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace_path)
        events = _trace_events(trace_path)
        os.remove(trace_path)
        d2h, biggest, calls, syncs, dropped = _copies_and_syncs(events)
        busy = _stream_overlap(events, ms)
        lost.append(dropped)
        if best is None or dropped < best[1]["dropped"]:
            best = (got, {"d2h": d2h, "d2h_max_bytes": biggest,
                          "copy_calls": calls, "syncs": syncs,
                          "dropped": dropped, "wall_ms": ms,
                          "device_ms": busy["device_ms"],
                          "device_idle_share": busy["device_idle_share"]})
        if not dropped:
            break
    best[1].update({"dropped_records": lost, "runs": len(lost)})
    return best


def same_copies(a, b) -> bool:
    """Two profiled runs made the same copies and syncs: equal copy calls
    (every direction) and cuda*Synchronize calls on the host, and
    device-to-host copies on the card that meet, each run's lying between
    its records and its records plus its calls whose record was dropped
    (the same count where neither dropped one)."""
    ra = (a["d2h"], a["d2h"] + a["dropped"])
    rb = (b["d2h"], b["d2h"] + b["dropped"])
    return (a["copy_calls"], a["syncs"]) == (b["copy_calls"], b["syncs"]) \
        and ra[0] <= rb[1] and rb[0] <= ra[1]


def _rollup_close(a, b) -> bool:
    """q1_rollup's groups equal: keys, the quantity sums (whole numbers)
    and the counts bitwise, the price sums and average discounts to
    1e-12 relative."""
    return set(a) == set(b) and all(
        a[k][0] == b[k][0] and a[k][3] == b[k][3]
        and _close(a[k][1], b[k][1], 1e-12)
        and _close(a[k][2], b[k][2], 1e-12) for k in a)


def phase_obs(want, h1, h8, pq_path, tmp_dir):
    """The live layer (module docstring, phase 17f): q1, q3join_shuffled,
    pq_repart_agg and q1_rollup, each warm with the layer off, then at
    its defaults with the endpoint on a free port scraped every 50 ms, in
    rounds: equal answers, the same device-to-host copies and syncs
    under torch.profiler, the registry's counters, monotone progress;
    q1_rollup's progress and /healthz while it runs; a fault's and an
    SLO breach's flight dumps."""
    from types import SimpleNamespace

    import torch

    from spark_rapids_tpu_torch.runtime import faults, obs
    from spark_rapids_tpu_torch.runtime.obs import sampler
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H, api = helpers(), port_api()
    PR = profiler_report()
    t_phase = time.perf_counter()
    flight_dir = os.path.join(tmp_dir, "flight")
    jwant = RUN_NOTES["q3join_shuffled_want"]

    def q1(s):
        return port_queries(DataFrame(h1.li.plan, s))["q1"]

    def q3(s):
        h8s = SimpleNamespace(s=s, li=DataFrame(h8.li.plan, s),
                              od=DataFrame(h8.od.plan, s))
        return joins_queries(h1, h8s)["q3join_shuffled"][1]

    def pq_repart(s):
        return port_queries(s.read_parquet(
            pq_path, columns=["l_shipdate", "l_quantity"]))["repart_agg"]

    def q1_rollup(s):
        li = DataFrame(h1.li.plan, s)

        def run():
            d = H.q1_rollup(api, li).collect().to_pydict()
            keys = ("l_returnflag", "l_linestatus", "gid")
            cols = ("sum_qty", "sum_price", "avg_disc", "n")
            return {tuple(d[k][i] for k in keys):
                    tuple(d[c][i] for c in cols)
                    for i in range(len(d[keys[0]]))}
        return run

    #: name -> (conf, the run's maker, its check, timed runs a mode,
    #: rounds, whether a round also runs the defaults unscraped)
    queries = {
        "q1": ({}, q1, lambda g: validate("q1", g, want["q1"]), 3, 1,
               True),
        "q3join_shuffled": (SHUFFLED_JOIN, q3, lambda g: validate_joins(
            "q3join_shuffled", g, jwant), 3, 1, True),
        "pq_repart_agg": ({}, pq_repart, lambda g: validate(
            "repart_agg", g, want["repart_agg"]), 1, 1, False),
        "q1_rollup": ({}, q1_rollup, lambda g: validate_sets(
            "q1_rollup", g, RUN_NOTES["q1_rollup_want"]), 1, 1, False),
    }
    reset_launches()
    problems = []

    def live_check(sc, got, s):
        """q1_rollup's timed run at the defaults: /queries shows it
        executing with progress that never goes down, and /healthz
        answers alive from the probe's side stream while the query's
        kernels are queued."""
        timeout_ms = float(s.conf.get("spark.rapids.obs.probeTimeoutMs"))
        running = [d for _, _, doc in sc.seen["/queries"]
                   for d in doc["running"] if d["state"] == "executing"]
        progress = [d.get("percent_complete") or 0.0 for d in running]
        scan_rows = [d["scan_rows"] for d in running]
        probes = [doc["device"] for _, _, doc in sc.seen["/healthz"]
                  if doc.get("queries", {}).get("active")]
        alive = [p["probe_ms"] for p in probes if p.get("alive")]
        live_doc = {"executing_scrapes": len(progress),
                    "progress_first_last": progress[:1] + progress[-1:],
                    "scan_rows_max": max(scan_rows, default=0),
                    "healthz_during_query": len(probes),
                    "probe_ms_max": max(alive, default=None),
                    "probe_ms_median": statistics.median(alive)
                    if alive else None, "errors": sc.errors[:3]}
        if not progress or progress != sorted(progress) \
                or scan_rows != sorted(scan_rows):
            problems.append(f"q1_rollup progress {live_doc}")
        if not alive or max(alive) >= timeout_ms \
                or any(not p.get("alive") for p in probes) or sc.errors:
            problems.append(f"q1_rollup healthz {live_doc}")
        emit({"phase": "obs.live", **live_doc})

    for name, (conf, make, check, reps, rounds, quiet) in queries.items():
        line = {"phase": "obs.query", "query": name}
        # off: the plain version; quiet: the defaults (no endpoint);
        # on: the defaults with the endpoint scraped, profiled with off
        per_round = ["off", "quiet", "on"] if quiet else ["off", "on"]
        warm = {m: [] for m in per_round}
        answers, progress, profiled_counts = {}, [], {}
        modes = per_round * rounds
        for i, mode in enumerate(modes):
            last = i >= len(modes) - len(per_round)  # the profiled round
            _obs_teardown()
            extra = OBS_OFF if mode == "off" else {
                "spark.rapids.obs.flight.path": flight_dir}
            if mode == "on":
                extra["spark.rapids.obs.port"] = str(_free_port())
            s = device_session({**conf, **extra})
            fn = make(s)
            st = obs.state()
            if (st is None) != (mode == "off"):
                problems.append(f"{name}: the live layer is "
                                f"{'on' if st else 'off'} in the {mode} run")
            # q1_rollup's timed run also scrapes /healthz: the live check
            routes = ("/queries", "/metrics") + (
                ("/healthz",) if name == "q1_rollup" else ())
            scraper = _Scraper(st.server.port, routes) \
                if mode == "on" else None
            smp = sampler.sampler()
            before = read_launches()
            n = 0
            if scraper is not None:
                scraper.__enter__()
            try:
                while n < reps or (name == "q1" and mode == "on" and last
                                   and smp.ticks < 2 and n < 20):
                    t0 = time.perf_counter()
                    got = fn()
                    torch.cuda.synchronize()
                    warm[mode].append((time.perf_counter() - t0) * 1e3)
                    n += 1
            finally:
                if scraper is not None:
                    scraper.__exit__()
            if name == "q1_rollup" and mode == "on":
                live_check(scraper, got, s)
            if last and mode != "quiet":
                # the profiled run scrapes /queries and /metrics only: a
                # /healthz probe makes a copy and a sync of its own
                prof_scraper = _Scraper(st.server.port, ("/queries",
                                                         "/metrics")) \
                    if mode == "on" else None
                if prof_scraper is not None:
                    prof_scraper.__enter__()
                try:
                    prof_got, counts = profiled_run(fn, os.path.join(
                        tmp_dir, f"obs_{name}_{mode}.json"))
                finally:
                    if prof_scraper is not None:
                        prof_scraper.__exit__()
                        scraper.seen["/queries"] += \
                            prof_scraper.seen["/queries"]
                        scraper.errors += prof_scraper.errors
                n += counts["runs"]
            if not check(got):
                problems.append(f"{name} ({mode}) disagrees")
            if mode != "off":
                snap = st.registry.snapshot()
                ok_n = snap['rapids_queries_total{status="ok"}']
                done = snap["rapids_tasks_completed_total"]
                if ok_n != n or done <= 0 or done % n \
                        or snap["rapids_tasks_failed_total"]:
                    problems.append(f"{name}: {ok_n} ok queries and {done} "
                                    f"tasks after {n} runs")
            if mode == "on":
                if scraper.errors or not scraper.seen["/queries"]:
                    problems.append(f"{name}: scrapes {scraper.errors[:3]}")
                by_q = {}
                for _, _, doc in scraper.seen["/queries"]:
                    for d in doc["running"]:
                        if d["state"] == "executing":
                            by_q.setdefault(d["query_id"], []).append(
                                d["scan_rows"])
                for rows in by_q.values():
                    progress.extend(rows)
                    if rows != sorted(rows):
                        problems.append(f"{name}: progress went down {rows}")
            if last and mode == "quiet":
                answers["quiet"] = (got, got)
            if not last or mode == "quiet":
                continue
            launches = {k: (v - before[k]) // n
                        for k, v in read_launches().items()}
            answers[mode] = (got, prof_got)
            profiled_counts[mode] = counts
            line.update({f"device_ms_{mode}": counts["device_ms"],
                         f"device_idle_share_{mode}":
                         counts["device_idle_share"],
                         f"d2h_copies_{mode}": counts["d2h"],
                         f"copy_calls_{mode}": counts["copy_calls"],
                         f"syncs_{mode}": counts["syncs"],
                         f"dropped_copy_records_{mode}":
                         counts["dropped_records"],
                         f"launches_per_run_{mode}": launches})
            if mode == "on":
                ring = smp.rings["device_bytes_held"].snapshot()
                code, hz = _http_json(
                    f"http://127.0.0.1:{st.server.port}/healthz")
                hz = json.loads(hz)
                line.update({
                    "queries_ok": ok_n, "tasks_per_run": done // n,
                    "scrapes": len(scraper.seen["/queries"]),
                    "scan_rows_max": max(progress, default=0),
                    "sampler_ticks": smp.ticks,
                    "sampler_device_bytes_held_max":
                        max((v for _, v, _ in ring), default=0.0),
                    "probe_ms": hz["device"].get("probe_ms"),
                    "healthz": hz["status"]})
                if name == "q1" and not any(v > 0 for _, v, _ in ring):
                    problems.append("the sampler saw no device bytes held "
                                    "during the cached q1")
                if name == "pq_repart_agg" and max(progress, default=0) <= 0:
                    problems.append("pq_repart_agg: no scan progress "
                                    "scraped")
        line.update({f"warm_ms_{m}": min(v) for m, v in warm.items()})
        line.update({f"warm_ms_median_{m}": statistics.median(v)
                     for m, v in warm.items()})
        line["on_over_off"] = line["warm_ms_on"] / line["warm_ms_off"]
        if quiet:
            line["quiet_over_off"] = line["warm_ms_quiet"] \
                / line["warm_ms_off"]
        (on, on2), (off, off2) = answers["on"], answers["off"]
        quiet_got = answers.get("quiet", (on,))[0]
        line["bitwise_equal"] = on == off == on2 == off2 == quiet_got
        if name == "q1_rollup":
            # its float sums add through the sort route's atomics, whose
            # order differs from run to run with the layer off as well:
            # held to the sets phase's tolerance, counts and the whole
            # quantities bitwise
            line["off_vs_off_bitwise"] = off == off2
            same = _rollup_close(on, off) and _rollup_close(off, off2) \
                and _rollup_close(on2, off)
        else:
            same = line["bitwise_equal"]
        if not same:
            problems.append(f"{name}: on and off answers differ")
        # a copy or sync the layer made would be one more call
        on_c, off_c = profiled_counts["on"], profiled_counts["off"]
        if not same_copies(on_c, off_c) or off_c["syncs"] <= 0:
            problems.append(f"{name}: copies and syncs on {on_c}, off "
                            f"{off_c}")
        if line["launches_per_run_on"] != line["launches_per_run_off"]:
            problems.append(f"{name}: launches differ on and off")
        emit(line)

    # a query failed by an injected fault leaves one flight dump, a
    # Chrome trace holding the query's queryStart marker and its id
    _obs_teardown()
    conf = {"spark.rapids.obs.flight.path": flight_dir,
            "spark.rapids.obs.flight.minIntervalSeconds": "0"}
    s = device_session({**conf, "spark.rapids.debug.faults":
                        "device.dispatch:ioerror"})
    before = set(os.listdir(flight_dir)) if os.path.isdir(flight_dir) \
        else set()
    err = None
    try:
        q1(s)()
    except Exception as e:  # noqa: BLE001 - the injected fault, checked
        err = e
    faults.configure("")
    dumps = sorted(set(os.listdir(flight_dir)) - before)
    fault_doc = {"raised": repr(err), "status": s.last_action_status,
                 "dumps": dumps}
    if len(dumps) != 1 or "query_failed" not in dumps[0]:
        problems.append(f"fault dump {fault_doc}")
    else:
        path = os.path.join(flight_dir, dumps[0])
        events = PR.validate_chrome_trace(path)
        qid = json.load(open(path))["otherData"]["query_id"]
        starts = [e for e in events if e["name"] == "queryStart"
                  and (e.get("args") or {}).get("query_id") == qid]
        fault_doc.update({"query_id": qid, "events": len(events),
                          "query_start_markers": len(starts)})
        if not isinstance(qid, int) or qid <= 0 or not starts:
            problems.append(f"fault dump {fault_doc}")
    emit({"phase": "obs.fault_dump", **fault_doc})

    # an SLO breach once the baseline has its minRuns: a tiny absolute
    # bound on the next run leaves a dump too
    s = device_session(conf)
    fn = q1(s)
    for _ in range(int(s.conf.get("spark.rapids.obs.slo.minRuns"))):
        fn()
    st = obs.state()
    breaches0 = st.slo.breaches
    before = set(os.listdir(flight_dir))
    s = device_session({**conf,
                        "spark.rapids.obs.slo.latencySeconds": "1e-6"})
    q1(s)()
    dumps = sorted(set(os.listdir(flight_dir)) - before)
    slo_doc = {"breaches": st.slo.breaches - breaches0, "dumps": dumps,
               "last_slow": (st.last_slow or {}).get("breach")}
    if st.slo.breaches - breaches0 != 1 or len(dumps) != 1 \
            or "slo_breach" not in dumps[0]:
        problems.append(f"slo dump {slo_doc}")
    else:
        events = PR.validate_chrome_trace(os.path.join(flight_dir,
                                                       dumps[0]))
        slo_doc["slow_query_instants"] = sum(
            1 for e in events if e["name"] == "slowQuery")
        if not slo_doc["slow_query_instants"]:
            problems.append(f"slo dump {slo_doc}")
    emit({"phase": "obs.slo_dump", **slo_doc})
    # the runtime phase runs at the defaults again
    _obs_teardown()
    counts = read_launches()
    emit({"phase": "obs", "launches": counts, "correct": not problems,
          "problems": problems, "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 17g: the query history, attribution and the measured cost pass
# ---------------------------------------------------------------------------

def history_queries(want, h1, h8, pq_path):
    """name -> (build(session) -> DataFrame, check(answer table) -> bool):
    q1 on the 1-partition cache, q3join_shuffled and pctl_shuffled on the
    8-partition caches, pq_repart_agg on the Parquet file."""
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H, api = helpers(), port_api()
    jwant = RUN_NOTES["q3join_shuffled_want"]
    pwant = RUN_NOTES["pctl_shuffled_want"]

    def q1_check(t):
        d = t.to_pydict()
        got = {(d["l_returnflag"][i], d["l_linestatus"][i]):
               tuple(d[c][i] for c in ("sq", "sp", "mq", "md", "cnt"))
               for i in range(t.num_rows)}
        return validate("q1", got, want["q1"])

    def q3_check(t):
        d = t.to_pydict()
        return validate_joins("q3join_shuffled",
                              dict(zip(d["l_orderkey"], d["rev"])), jwant)

    def repart_check(t):
        d = t.to_pydict()
        return validate("repart_agg", {k: (s, c) for k, s, c in zip(
            d["l_shipdate"], d["s"], d["c"])}, want["repart_agg"])

    return {
        "q1": (lambda s: H.q1(api, DataFrame(h1.li.plan, s)), q1_check),
        "q3join_shuffled": (lambda s: H.q3join(
            api, DataFrame(h8.li.plan, s), DataFrame(h8.od.plan, s)),
            q3_check),
        "pq_repart_agg": (lambda s: H.repart_agg(api, s.read_parquet(
            pq_path, columns=["l_shipdate", "l_quantity"])), repart_check),
        "pctl_shuffled": (lambda s: H.pctl_shuffled(
            api, DataFrame(h8.li.plan, s)),
            lambda t: validate_exprs("pctl_shuffled", t, pwant)),
    }


def _attribution_ok(doc) -> bool:
    return bool(doc) and abs(sum(doc["buckets"].values())
                             - doc["wall_seconds"]) \
        <= 0.01 * doc["wall_seconds"]


def phase_history(want, h1, h8, pq_path, tmp_dir):
    """The query history, attribution and the measured cost pass (module
    docstring, phase 17g): four queries with the live layer off
    ("plain"), at the defaults and with spark.rapids.obs.historyDir set,
    their records, copies and syncs; pctl_shuffled's measured collapse;
    EXPLAIN ANALYZE and the device handoff of q1."""
    import contextlib
    import io

    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.runtime import obs
    from spark_rapids_tpu_torch.runtime.obs.history import plan_digest
    t_phase = time.perf_counter()
    hist_dir = os.path.join(tmp_dir, "history")
    queries = history_queries(want, h1, h8, pq_path)
    modes = {"plain": OBS_OFF, "default": {},
             "history": {"spark.rapids.obs.historyDir": hist_dir}}
    reset_launches()
    problems = []
    lines = {n: {"phase": "history.query", "query": n} for n in queries}
    answers, counts = {}, {}
    digests = {n: None for n in queries}
    #: each query's last collected DataFrame: its plan is the pruned one
    #: the records digest (convert_plan prunes in place, ROADMAP C26)
    last_df = {}
    s = None
    from spark_rapids_tpu_torch.sql.session import TorchSession
    attribute = TorchSession._attribute
    mode_s = {}
    for mode, extra in modes.items():
        t_mode = time.perf_counter()
        _obs_teardown()
        s = device_session({**SHUFFLED_JOIN, **extra})
        # the plain version: the live layer off and no attribution fold
        plain = mode == "plain"
        TorchSession._attribute = (lambda self, lm, ns: None) if plain \
            else attribute
        walls = []

        def run(name, build):
            df = last_df[name] = build(s)
            t = df.collect()
            if not plain:
                walls.append(s.last_attribution()["wall_seconds"])
            return t

        try:
            for name, (build, check) in queries.items():
                line = lines[name]
                if not plain:  # the caches are warm: plain runs warm only
                    t0 = time.perf_counter()
                    got = run(name, build)
                    torch.cuda.synchronize()
                    line[f"cold_ms_{mode}"] = \
                        (time.perf_counter() - t0) * 1e3
                    if not check(got):
                        problems.append(f"{name} ({mode}, cold) disagrees")
                before = read_launches()
                # one profiled run: late in the script the profiler drops
                # pq_repart_agg's copy records in every run, and
                # same_copies counts the dropped calls
                got, c = profiled_run(
                    lambda: run(name, build),
                    os.path.join(tmp_dir, f"history_{name}_{mode}.json"),
                    tries=1)
                line[f"launches_per_run_{mode}"] = {
                    k: (v - before[k]) // c["runs"]
                    for k, v in read_launches().items()}
                counts[(name, mode)] = c
                answers[(name, mode)] = got
                if not check(got):
                    problems.append(f"{name} ({mode}) disagrees")
                line.update({f"{k}_{mode}": c[k] for k in (
                    "wall_ms", "device_ms", "device_idle_share", "d2h",
                    "d2h_max_bytes", "copy_calls", "syncs",
                    "dropped_records")})
                if plain:
                    continue
                attr = s.last_attribution()
                if not _attribution_ok(attr):
                    problems.append(f"{name} ({mode}) attribution {attr}")
                line[f"buckets_ms_{mode}"] = {
                    b: v * 1e3 for b, v in attr["buckets"].items() if v > 0}
                if mode == "history":
                    digests[name] = plan_digest(last_df[name].plan)
                    rec = obs.state().history.read_all()[-1]
                    rows = {k: v.get("numOutputRows")
                            for k, v in s.last_metrics().items()}
                    if {k: v.get("numOutputRows") for k, v in
                            rec.get("execs", {}).items()} != rows:
                        problems.append(f"{name}: record rows differ from "
                                        f"last_metrics()")
        finally:
            TorchSession._attribute = attribute
        mode_s[mode] = time.perf_counter() - t_mode
        st = obs.state()
        if mode == "default":
            # the counter of every top-level action's buckets
            snap = st.registry.snapshot()
            exported = sum(v for k, v in snap.items()
                           if k.startswith("rapids_query_seconds_bucket"))
            if not _close(exported, sum(walls), 1e-6):
                problems.append(f"rapids_query_seconds_bucket {exported} "
                                f"against {sum(walls)} s of wall")
            if st.history is not None:
                problems.append("a history store without historyDir")
    for name, line in lines.items():
        bare, dflt, hist = (counts[(name, m)] for m in modes)
        # the default epilogue (the live layer and the attribution fold)
        # against neither, and what the record adds
        if not same_copies(dflt, bare):
            problems.append(f"{name}: the default epilogue's copies/syncs "
                            f"{dflt} differ from the plain run's {bare}")
        line["history_added"] = {
            "d2h": hist["d2h"] - dflt["d2h"],
            "copy_calls": hist["copy_calls"] - dflt["copy_calls"],
            "syncs": hist["syncs"] - dflt["syncs"]}
        outs = [answers[(name, m)] for m in modes]
        line["answers_equal"] = all(o.equals(outs[0]) for o in outs)
        if not line["answers_equal"]:
            problems.append(f"{name}: answers differ between modes")
        if len({tuple(line[f"launches_per_run_{m}"].items())
                for m in modes}) != 1:
            problems.append(f"{name}: launches differ between modes")
    # every record of the history runs
    recs = obs.state().history.read_all()
    bad = [r.get("plan_digest") for r in recs
           if r.get("status") != "ok" or not r.get("annotated_plan")
           or not r.get("execs") or not _attribution_ok(r.get("attribution"))
           or r.get("plan_digest") not in digests.values()]
    per_digest = {n: sum(1 for r in recs if r.get("plan_digest") == d)
                  for n, d in digests.items()}
    if bad or len(set(digests.values())) != len(digests) \
            or any(v < 2 for v in per_digest.values()):
        problems.append(f"history records: bad {bad}, per query "
                        f"{per_digest}")
    for line in lines.values():
        emit(line)

    # the measured collapse: a dispatch-bound shuffle verdict appended to
    # pctl_shuffled's history turns its hash exchange into a collect
    build, check = queries["pctl_shuffled"]
    store = obs.state().history

    def timed():
        before = read_launches()
        t0 = time.perf_counter()
        got = build(s).collect()
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3, {
            k: v - before[k] for k, v in read_launches().items()}

    uncollapsed, warm_before, launch_before = timed()
    digest = digests["pctl_shuffled"]
    rec = dict([r for r in store.by_digest(digest)
                if r.get("status") == "ok"][-1])
    rec["roofline"] = {"groups": {"shuffle": {"bound": "dispatch_overhead"}}}
    store.append(rec)
    cold_after, cold_ms, _ = timed()
    collapsed, warm_after, launch_after = timed()
    execs = _exec_names(s)
    decisions = [d for d in (s.last_aqe() or {}).get("decisions", [])
                 if d["kind"] == "measured_cost"]
    same = collapsed.sort_by("l_shipdate").equals(
        uncollapsed.sort_by("l_shipdate"))
    collapse = {"phase": "history.collapse", "digest": digest,
                "warm_ms_before": warm_before, "cold_ms_after": cold_ms,
                "warm_ms_after": warm_after,
                "murmur3_before": launch_before["murmur3_int32"],
                "murmur3_after": launch_after["murmur3_int32"],
                "execs": execs, "decision": decisions[:1],
                "equal_sorted_by_key": same}
    emit(collapse)
    if "ShuffleExchangeExec" in execs \
            or "CollectExchangeExec" not in execs or len(decisions) != 1 \
            or not same or not check(collapsed) or not check(cold_after):
        problems.append(f"measured collapse {collapse}")

    # EXPLAIN ANALYZE and the device handoff of q1
    build, check = queries["q1"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        text = build(s).explain("analyze")
    lines_ = text.splitlines()
    report = {"phase": "history.reports", "analyze_lines": len(lines_),
              "analyze_printed": out.getvalue().strip() == text.strip(),
              "analyze_head": lines_[:2]}
    if not report["analyze_printed"] or not all(
            f in text for f in ("rows=", "batches=", "time=",
                                "-- time attribution (wall ")):
        problems.append(f"explain analyze: {text[:400]}")
    batches, c = profiled_run(
        lambda: build(s).to_device_batches(),
        os.path.join(tmp_dir, "history_q1_handoff.json"))
    from spark_rapids_tpu_torch.columnar.batch import to_arrow
    names = answers[("q1", "default")].schema.names
    handoff = pa.concat_tables([to_arrow(b, names) for b in batches])
    collect = counts[("q1", "default")]
    # the collect downloads each result column's live rows (one copy a
    # plane at least); the handoff reads row counts only
    report.update({
        "handoff_batches": len(batches),
        "handoff_on_cuda": all(col.device.type == "cuda" for b in batches
                               for col in b.columns),
        "handoff_d2h": c["d2h"], "handoff_d2h_max_bytes": c["d2h_max_bytes"],
        "handoff_dropped": c["dropped_records"],
        "collect_d2h": collect["d2h"],
        "collect_d2h_max_bytes": collect["d2h_max_bytes"],
        "handoff_equals_collect": handoff.equals(answers[("q1", "default")])})
    emit(report)
    if not report["handoff_on_cuda"] or not report["handoff_equals_collect"] \
            or c["d2h"] + c["dropped"] + len(names) > collect["d2h"]:
        problems.append(f"to_device_batches {report}")
    # the runtime phase runs at the defaults again
    _obs_teardown()
    launches = read_launches()
    emit({"phase": "history", "launches": launches, "mode_s": mode_s,
          "records": len(store.read_all()), "correct": not problems,
          "problems": problems, "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 17h: stage fusion
# ---------------------------------------------------------------------------

FUSION_OFF = {"spark.rapids.sql.stageFusion.enabled": "false"}
#: queries whose Expand changes form with fusion (a batch a projection
#: off, one stacked batch on), so their aggregate's B2 launches differ
FUSION_FORM_CHANGES = ("rollup_shipdate",)
#: the range names FusedStageExec and an absorbing aggregate open around
#: each batch's call while a profiler records (exec/fuse.stage_range)
STAGE_RANGES = ("FusedStage#", "AbsorbedStage#")


def fusion_reference(t) -> dict:
    """numpy answers of the fusion phase's queries that the other
    references do not give: rollup_shipdate's groups (year, week; with the
    rollup's subtotals) -> (revenue, lines), and limit_chain's rows."""
    H = helpers()
    sd = t.column("l_shipdate").to_numpy()
    rev = t.column("l_extendedprice").to_numpy() * (
        1.0 - t.column("l_discount").to_numpy())
    year, week = sd // 365, sd // 7
    wmax = int(week.max()) + 1
    idx = year * wmax + week
    size = (int(year.max()) + 1) * wmax
    n = np.bincount(idx, minlength=size)
    r = np.bincount(idx, weights=rev, minlength=size)
    roll = {}
    for i in np.flatnonzero(n):
        roll[(int(i // wmax), int(i % wmax))] = (float(r[i]), int(n[i]))
    ny = np.bincount(year)
    ry = np.bincount(year, weights=rev)
    for y in np.flatnonzero(ny):
        roll[(int(y), None)] = (float(ry[y]), int(ny[y]))
    roll[(None, None)] = (float(rev.sum()), int(len(sd)))
    return {"rollup_shipdate": roll,
            "limit_chain": H.limit_chain_answer(t)}


def _fusion_answer(name, table):
    """A fusion-phase result (pyarrow table) in the shape its reference
    check takes."""
    d = table.to_pydict()
    if name in ("q6", "pq_q6"):
        return list(d.values())[0][0]
    if name == "q1":
        return {(rf, ls): (sq, sp, mq, md, c) for rf, ls, sq, sp, mq, md, c
                in zip(d["l_returnflag"], d["l_linestatus"], d["sq"],
                       d["sp"], d["mq"], d["md"], d["cnt"])}
    if name in ("q72shfl", "q72shfl_repart"):
        return {int(k): (s, c) for k, s, c in zip(d["k"], d["s"], d["c"])}
    if name == "rollup_shipdate":
        return {(y, w): (v, n) for y, w, v, n in
                zip(d["ship_year"], d["ship_week"], d["rev"], d["n"])}
    return d


def _fusion_check(name, got, want, fwant) -> bool:
    """The result against numpy or pyarrow."""
    if name in ("q6", "pq_q6"):
        return validate("q6", got, want["q6"])
    if name == "q1":
        return validate("q1", got, want["q1"])
    if name in ("q72shfl", "q72shfl_repart"):
        return validate("q72shfl_groups", got, want["q72shfl_groups"])
    if name == "rollup_shipdate":
        ref = fwant[name]
        return set(got) == set(ref) and all(
            _close(got[k][0], ref[k][0], 1e-9) and got[k][1] == ref[k][1]
            for k in ref)
    return got == fwant[name]


def _same_answer(name, a, b) -> tuple:
    """(bitwise equal, the largest relative difference of a float sum) of
    the fusion-off and -on answers, or (False, None) when keys or counts
    differ. Only rollup_shipdate's Expand changes form: one batch a
    projection off, one stacked batch on, so its float sums may take
    other chunks on the packed route; the sets phase holds them to 1e-6."""
    if a == b:
        return True, 0.0
    if name == "rollup_shipdate" and set(a) == set(b) \
            and all(a[k][1] == b[k][1] for k in a):
        return False, max(abs(a[k][0] - b[k][0])
                          / max(1.0, abs(a[k][0]), abs(b[k][0])) for k in a)
    return False, None


def _stage_profile(fn):
    """One run of fn under torch.profiler (host and card): per fused or
    absorbed stage range, the batches (ranges), the CUDA kernel launches
    issued inside them a batch, and the host ms a batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_stage_"),
                        "trace.json")
    prof.export_chrome_trace(path)
    events = _trace_events(path)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    ranges = [e for e in events if e.get("ph") == "X" and any(
        str(e.get("name", "")).startswith(p) for p in STAGE_RANGES)
        and str(e.get("cat", "")) != "gpu_user_annotation"]
    launches = [e for e in events
                if str(e.get("cat", "")).startswith("cuda_")
                and "LaunchKernel" in str(e.get("name", ""))]
    out = {}
    for r in ranges:
        t0, t1 = float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0))
        n = sum(1 for k in launches if k.get("tid") == r.get("tid")
                and t0 <= float(k["ts"]) <= t1)
        s = out.setdefault(r["name"], {"batches": 0, "launches": 0,
                                       "host_us": 0.0})
        s["batches"] += 1
        s["launches"] += n
        s["host_us"] += float(r.get("dur", 0))
    return {name: {"batches": s["batches"],
                   "launches_per_batch": s["launches"] / s["batches"],
                   "host_ms_per_batch": s["host_us"] / s["batches"] / 1e3}
            for name, s in out.items()}


def _stage_dispatch_counts(session) -> dict:
    """stageDispatches and the input batches of the last query's fused
    stages and absorbing aggregates."""
    disp = batches = 0
    for e in session.last_exec.walk():
        if getattr(e, "members", None) or getattr(e, "pre_chain_members",
                                                  None):
            disp += e.metrics.metric("stageDispatches").value
            batches += e.metrics.metric("numInputBatches").value
    return {"stageDispatches": disp, "input_batches": batches}


def _decoded_batches(session) -> dict:
    """The batches the last query pulled through its device decode (the
    fused stage's input batches with fusion on, the decode's output
    batches off) and the batches its Parquet source read."""
    pulled = read = 0
    for e in session.last_exec.walk():
        name = type(e).__name__
        if name == "FusedStageExec" and any(
                type(m).__name__ == "DeviceDecodeScanExec"
                for m in e.members):
            pulled += e.metrics.metric("numInputBatches").value
        elif name == "DeviceDecodeScanExec":
            # a fused member's own loop never runs: 0 with fusion on
            pulled += e.metrics.metric("numOutputBatches").value
        elif name == "EncodedParquetSourceExec":
            read += e.metrics.metric("numOutputBatches").value
    return {"batches_pulled": pulled, "source_batches_read": read}


def phase_fusion(want, fwant, h1, pq_path, tmp_dir, prof=None):
    """Stage fusion (module docstring, phase 17h): the queries of
    torch_port_helpers.fusion_queries over the 1-partition lineitem cache
    and the Parquet file, with spark.rapids.sql.stageFusion.enabled off
    and on: plan (fusion groups against the JAX package's, held in
    FUSION_EXPECT), stageDispatches against input batches, warm ms,
    device ms and idle share, peak GB, B1-B3 launches a run, and inside
    each fused or absorbed stage the kernel launches and host ms a
    batch; answers equal off and on and against numpy/pyarrow."""
    import pyarrow.parquet as pq
    import torch

    from spark_rapids_tpu_torch.analysis.plan_verify import dispatch_budget
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H = helpers()
    t_phase = time.perf_counter()
    sessions = {"off": device_session(FUSION_OFF), "on": device_session()}
    cached = {m: DataFrame(h1.li.plan, s) for m, s in sessions.items()}
    row_groups = pq.ParquetFile(pq_path).metadata.num_row_groups
    reset_launches()
    problems = []
    for name, build in H.fusion_queries(port_api()).items():
        line = {"phase": "fusion.query", "query": name}
        answers = {}
        launches = {}
        runs = {m: [] for m in sessions}

        def run(mode):
            s = sessions[mode]
            return build(s, cached[mode], pq_path).collect()

        for mode in ("off", "on"):  # cold
            answers[mode] = _fusion_answer(name, run(mode))
        for _ in range(WARM_RUNS + 1):  # warm, off and on in turns
            for mode in ("off", "on"):
                before = read_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(mode)
                torch.cuda.synchronize()
                runs[mode].append((time.perf_counter() - t0) * 1e3)
                launches[mode] = {k: v - before[k]
                                  for k, v in read_launches().items()}
        for mode, s in sessions.items():
            budget = dispatch_budget(s.last_exec)
            line[f"warm_ms_{mode}"] = min(runs[mode])
            line[f"launches_per_run_{mode}"] = launches[mode]
            if mode == "on":
                line.update({k: budget[k] for k in (
                    "fused_stages", "absorbed_stages", "fusion_groups",
                    "narrow_dispatches_per_batch")})
                line.update(_stage_dispatch_counts(s))
            elif budget["fusion_groups"]:
                problems.append(f"{name} planned fusion groups with fusion "
                                f"off: {budget['fusion_groups']}")
            if name == "limit_chain":
                line.update({f"{k}_{mode}": v for k, v in
                             _decoded_batches(s).items()})
            torch.cuda.reset_peak_memory_stats()
            got, c = profiled_run(
                lambda m=mode: run(m),
                os.path.join(tmp_dir, f"fusion_{name}_{mode}.json"),
                tries=1)
            line[f"peak_gb_{mode}"] = torch.cuda.max_memory_allocated() / 1e9
            line.update({f"{k}_{mode}": c[k] for k in (
                "wall_ms", "device_ms", "device_idle_share")})
        line["warm_on_off_ratio"] = line["warm_ms_on"] / line["warm_ms_off"]
        line["device_ms_on_off_ratio"] = (
            line["device_ms_on"] / line["device_ms_off"]
            if line["device_ms_off"] else None)
        line["stages"] = _stage_profile(lambda: run("on"))
        exact, rel = _same_answer(name, answers["off"], answers["on"])
        close = rel is not None and rel <= 1e-6
        line["equal_off_on"] = exact
        line["max_rel_diff_off_on"] = rel
        line["correct_off"] = _fusion_check(name, answers["off"], want,
                                            fwant)
        line["correct_on"] = _fusion_check(name, answers["on"], want, fwant)
        emit(line)
        if not (close and line["correct_off"] and line["correct_on"]):
            problems.append(f"{name}: answers off/on equal {exact} "
                            f"(largest relative difference {rel}), correct off "
                            f"{line['correct_off']}, on {line['correct_on']}")
        if line["fusion_groups"] != H.FUSION_EXPECT[name]:
            problems.append(f"{name} planned {line['fusion_groups']}, the "
                            f"JAX package {H.FUSION_EXPECT[name]}")
        if line["stageDispatches"] != line["input_batches"]:
            problems.append(f"{name}: {line['stageDispatches']} stage "
                            f"dispatches for {line['input_batches']} batches")
        bl = ("murmur3_int32", "segsum", "bitslice")
        if name in FUSION_FORM_CHANGES:
            # the Expand's form decides the aggregate's batches: one a
            # projection off (only the full grouping set's takes the
            # chunked segsum route), one stacked batch on, whose B2 count
            # is the sets phase's (which runs fused)
            bl = ("murmur3_int32", "bitslice")
            if launches["on"]["segsum"] != \
                    SETS_LAUNCHES[name]["segsum"]:
                problems.append(f"{name}: B2 launched "
                                f"{launches['on']['segsum']} times on, "
                                f"the stacked form's "
                                f"{SETS_LAUNCHES[name]['segsum']} expected")
        if any(launches["off"][k] != launches["on"][k] for k in bl):
            problems.append(f"{name}: B1-B3 launches off {launches['off']}"
                            f" on {launches['on']}")
        if line["fusion_groups"] and not line["stages"]:
            problems.append(f"{name}: no stage range in the profiled run")
        if name == "pq_q6" and not launches["on"]["bitslice"]:
            problems.append("pq_q6 launched no bitslice from its stage")
        if name == "limit_chain":
            on, off = line["batches_pulled_on"], line["batches_pulled_off"]
            if not 0 < on < row_groups or on > off:
                problems.append(f"limit_chain pulled {on} batches on, "
                                f"{off} off, of {row_groups}")
    if prof:
        prof.run("fusion", {
            name: (lambda b=b: b(sessions["on"], cached["on"],
                                 pq_path).collect())
            for name, b in H.fusion_queries(port_api()).items()})
    counts = read_launches()
    emit({"phase": "fusion", "launches": counts, "problems": problems,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("fusion phase: " + "; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# phase 17i: the kernel cost audit, the roofline, the compile counters,
# warmup and the profile dir
# ---------------------------------------------------------------------------

AUDIT_ON = {"spark.rapids.obs.audit.enabled": "true"}
#: the NDS probe's cold prefix the CPU golden pins
#: (tests/torch_cost_signatures.json)
AUDIT_PREFIX = 2
#: the small tables the card and the CPU both run, so each hand kernel's
#: charge is compared on the same inputs
AUDIT_SMALL_ROWS = 200_000
AUDIT_TEXT_ROWS = 50_000
#: the warmup phase's recurring SQL statement (over the 1-partition cache)
AUDIT_WARMUP_SQL = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS "
                    "sq, COUNT(*) AS n FROM lineitem WHERE l_shipdate > "
                    "9000 GROUP BY l_returnflag, l_linestatus")
#: the window and join families whose dispatches pass exec/fuse.fused
WINDOW_JOIN_FAMILIES = ("window_sortlay", "window_fns", "window_packed",
                        "window", "dense_probe_masked")


def _audit_tool():
    """tools/torch_gen_cost_signatures.py: the golden recipe (the NDS
    probe's builders on the port, fresh audited sessions)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_gen_cost_signatures.py")
    spec = importlib.util.spec_from_file_location("torch_gen_cost_sigs",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _op_diff(card_ops, cpu_ops, top=12):
    """The aten ops whose charged bytes differ between the card and the
    CPU, largest difference first."""
    names = set(card_ops) | set(cpu_ops)
    diffs = sorted(((n, card_ops.get(n, 0) - cpu_ops.get(n, 0))
                    for n in names), key=lambda kv: -abs(kv[1]))
    return {n: d for n, d in diffs[:top] if d}


def _running_by_flags(api, df):
    col, F = api.col, api.F
    w = api.Window.partition_by(col("l_returnflag"), col("l_linestatus")) \
        .order_by(col("l_shipdate"))
    return (df.select(col("l_returnflag"), col("l_linestatus"),
                      F.sum(col("l_quantity")).over(w).alias("rs"))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.max("rs").alias("mx")))


def phase_audit(h1, h8, built, tmp_dir):
    """The kernel cost audit (analysis/kernel_audit.py) and the second
    part of the compile layer, with the run's numbers beside the card:
    - determinism: two cold audited runs of the NDS probe's cold prefix,
      q1_rollup (the 1-partition cache) and q3join_shuffled (the
      8-partition caches) give equal signatures;
    - card against CPU: the prefix's signature against the CPU golden
      (the aten ops whose bytes differ printed), and repart_agg (B1, B2),
      pq_q6 over a small file (B3) and str_case_agg (B4) on small tables
      on both: the hand kernels' charges must be equal;
    - per query, the roofline groups and the achieved GB/s two ways: over
      the attribution's device_compute seconds and over the profiler's
      device ms, each as a share of 3350 GB/s;
    - the audit's cost: warm ms with the audit on over off;
    - a real audited record driving the measured pass (pctl_shuffled);
    - warmup: plans replayed and failed, and the first user query's wall
      with warmup against without, both after compile_cache.clear();
    - spark.rapids.profile.dir: the trace exists, parses and names a hand
      kernel;
    - the compile counters against phase_build's builds and the loads;
    - the window and join families' dispatches through fuse.fused."""
    import pyarrow.parquet as pq
    import torch

    from spark_rapids_tpu_torch.analysis import kernel_audit as KA
    from spark_rapids_tpu_torch.exec import fuse
    from spark_rapids_tpu_torch.ops import _build
    from spark_rapids_tpu_torch.runtime import compile_cache as CC
    from spark_rapids_tpu_torch.runtime import obs, warmup
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    H, api = helpers(), port_api()
    t_phase = time.perf_counter()
    gen = _audit_tool()
    reset_launches()
    problems = []
    card = nvidia_smi()
    _obs_teardown()

    def big_queries(s):
        return {"q1_rollup": lambda: H.q1_rollup(
                    api, DataFrame(h1.li.plan, s)),
                "q3join_shuffled": lambda: H.q3join(
                    api, DataFrame(h8.li.plan, s),
                    DataFrame(h8.od.plan, s))}

    # -- determinism: two cold audited runs --------------------------------
    runs, summaries = [], {}
    for rep in range(2):
        t0 = time.perf_counter()
        nsess, tables, nds = gen.cold_session("cuda")
        sigs = {}
        for qn in sorted(nds.QUERIES)[:AUDIT_PREFIX]:
            nds.QUERIES[qn](nsess, tables).collect()
            sigs[f"nds_q{qn}"] = KA.query_signature(nsess.last_audit())
            summaries[f"nds_q{qn}"] = nsess.last_audit()
        s = device_session({**SHUFFLED_JOIN, **AUDIT_ON})
        for name, build in big_queries(s).items():
            build().collect()
            sigs[name] = KA.query_signature(s.last_audit())
            summaries[name] = s.last_audit()
        runs.append({"sigs": sigs, "seconds": time.perf_counter() - t0,
                     "findings": KA.findings()})
        del nsess, tables
    same = json.dumps(runs[0]["sigs"], sort_keys=True) == \
        json.dumps(runs[1]["sigs"], sort_keys=True)
    det = {"phase": "audit.determinism", "equal": same,
           "cold_run_s": [r["seconds"] for r in runs],
           "findings": runs[1]["findings"][:5],
           "families": {n: sorted(v) for n, v in runs[0]["sigs"].items()},
           "total_bytes": {n: int(summaries[n]["total"]["bytes_accessed"])
                           for n in summaries},
           "kernels": {n: summaries[n]["kernels"] for n in summaries},
           "card": card}
    emit(det)
    if not same or runs[1]["findings"] \
            or any(not v for v in runs[0]["sigs"].values()):
        problems.append(f"audit signatures differ or are incomplete: "
                        f"{[r['sigs'] for r in runs]}")

    # -- card against the CPU ------------------------------------------------
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_cost_signatures.json")) as f:
        golden = json.load(f)["cost_signatures"]
    csess, ctables, cnds = gen.cold_session("cpu")
    golden_diffs, op_diffs = [], {}
    for qn in sorted(cnds.QUERIES)[:AUDIT_PREFIX]:
        cnds.QUERIES[qn](csess, ctables).collect()
        cpu = csess.last_audit()
        golden_diffs += KA.compare_signature(
            f"q{qn} cpu", golden[str(qn)], KA.query_signature(cpu))
        golden_diffs += KA.compare_signature(
            f"q{qn} card", golden[str(qn)], runs[1]["sigs"][f"nds_q{qn}"])
        op_diffs[f"nds_q{qn}"] = _op_diff(summaries[f"nds_q{qn}"]["ops"],
                                          cpu["ops"])
    del csess, ctables
    li, od_small = H.make_tables(AUDIT_SMALL_ROWS)
    text = H.make_lineitem_text(AUDIT_TEXT_ROWS)
    small_pq = os.path.join(tmp_dir, "audit_small.parquet")
    pq.write_table(li, small_pq, **{**PARQUET_WRITE,
                                    "row_group_size": 1 << 16})
    kernel_cmp = {}
    for dev in ("cuda", "cpu"):
        from spark_rapids_tpu_torch import TorchSession
        s = TorchSession({**SHUFFLED_JOIN, **AUDIT_ON}, device=dev)
        KA.clear_for_cold_audit()
        small = {
            "repart_agg": lambda: H.repart_agg(
                api, s.create_dataframe(li, num_partitions=8)),
            "pq_q6": lambda: H.q6(api, s.read_parquet(small_pq)),
            "str_case_agg": lambda: H.str_case_agg(
                api, s.create_dataframe(text))}
        for name, build in small.items():
            build().collect()
            a = s.last_audit()
            kernel_cmp.setdefault(name, {})[dev] = {
                "kernels": a["kernels"], "ops": a["ops"],
                "sig": KA.query_signature(a)}
    kernel_lines = {}
    for name, by in kernel_cmp.items():
        kc, kp = by["cuda"]["kernels"], by["cpu"]["kernels"]
        kernel_lines[name] = {
            "kernels_card": kc, "kernels_cpu": kp, "equal": kc == kp,
            "signature_equal": by["cuda"]["sig"] == by["cpu"]["sig"],
            "op_bytes_card_minus_cpu": _op_diff(by["cuda"]["ops"],
                                                by["cpu"]["ops"])}
        if kc != kp or not kc:
            problems.append(f"{name}: hand kernel charges differ card "
                            f"{kc} / CPU {kp}")
    charged = set().union(*[set(v["kernels_card"])
                            for v in kernel_lines.values()])
    if charged != {"murmur3_int32", "segsum", "bitslice", "case_map"}:
        problems.append(f"the small queries charged {charged}")
    emit({"phase": "audit.card_vs_cpu", "golden_diffs": golden_diffs,
          "nds_op_bytes_card_minus_cpu": op_diffs,
          "small": kernel_lines, "card": card})

    # -- per query roofline: attribution seconds and profiler device ms ----
    s = device_session({**SHUFFLED_JOIN, **AUDIT_ON})
    nsess, tables, nds = gen.cold_session("cuda")
    per_query = {f"nds_q{qn}": (nsess, lambda qn=qn: nds.QUERIES[qn](
        nsess, tables)) for qn in sorted(nds.QUERIES)[:AUDIT_PREFIX]}
    per_query.update({n: (s, b) for n, b in big_queries(s).items()})
    roof_lines = {}
    for name, (sess, build) in per_query.items():
        build().collect()  # cold: the audited run
        got, c = profiled_run(lambda: build().collect(),
                              os.path.join(tmp_dir, f"audit_{name}.json"),
                              tries=1)
        roof = sess.last_roofline()
        tot = roof["total"]
        gbytes = tot["bytes_accessed"]
        dev_s = c["device_ms"] / 1e3
        by_dev = gbytes / dev_s / 1e9 if dev_s > 0 else 0.0
        roof_lines[name] = {
            "groups": {g: {k: v[k] for k in (
                "seconds", "dispatches", "bytes_accessed", "flops",
                "achieved_gbps", "roofline_pct_bw", "achieved_gflops",
                "bound", "padding_waste_ratio")}
                for g, v in roof["groups"].items()},
            "bytes": gbytes, "pcie_bytes": int(
                sess.last_audit()["total"]["pcie_bytes"]),
            "top_ops_bytes": dict(sorted(
                sess.last_audit()["ops"].items(),
                key=lambda kv: -kv[1])[:6]),
            "attribution_s": tot["seconds"],
            "gbps_over_attribution": tot["achieved_gbps"],
            "pct_over_attribution": tot["roofline_pct_bw"],
            "profiler_device_ms": c["device_ms"],
            "gbps_over_device_ms": by_dev,
            "pct_over_device_ms": 100.0 * by_dev / 3350.0,
            "attribution_over_device": (tot["seconds"] / dev_s
                                        if dev_s > 0 else None),
            "wall_ms": c["wall_ms"], "idle": c["device_idle_share"]}
    emit({"phase": "audit.roofline", "queries": roof_lines, "card": card})
    del nsess, tables

    # -- the audit's cost: warm ms on over off -------------------------------
    overhead = {}
    for name in ("q1_rollup", "q3join_shuffled"):
        ms = {}
        for mode, extra in (("on", AUDIT_ON), ("off", {})):
            sess = device_session({**SHUFFLED_JOIN, **extra})
            build = big_queries(sess)[name]
            build().collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build().collect()
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
        overhead[name] = {"warm_ms_on": ms["on"], "warm_ms_off": ms["off"],
                          "ratio": ms["on"] / ms["off"]}
    emit({"phase": "audit.overhead", "queries": overhead, "card": card})

    # -- a real audited record drives the measured pass ----------------------
    hist = os.path.join(tmp_dir, "audit_history")
    _obs_teardown()
    s = device_session({**SHUFFLED_JOIN, **AUDIT_ON,
                        "spark.rapids.obs.historyDir": hist})
    pctl = lambda: H.pctl_shuffled(api, DataFrame(h8.li.plan, s))  # noqa
    first = pctl().collect()
    verdict = s.last_roofline()["groups"].get("shuffle", {}).get("bound")
    first_execs = _exec_names(s)
    second = pctl().collect()
    decisions = [d for d in (s.last_aqe() or {}).get("decisions", [])
                 if d["kind"] == "measured_cost"]
    collapse = {"phase": "audit.measured_pass", "shuffle_verdict": verdict,
                "execs_before": first_execs, "execs_after": _exec_names(s),
                "decisions": decisions[:1],
                "equal": first.sort_by("l_shipdate").equals(
                    second.sort_by("l_shipdate")),
                "record_has_roofline": bool(
                    obs.state().history.read_all()[0].get("roofline"))}
    emit(collapse)
    if not collapse["record_has_roofline"] or not collapse["equal"] or (
            verdict == "dispatch_overhead"
            and (len(decisions) != 1
                 or "ShuffleExchangeExec" in collapse["execs_after"])):
        problems.append(f"measured pass from an audited record {collapse}")
    _obs_teardown()

    # -- warmup: replays from history, then the first user query -------------
    hist = os.path.join(tmp_dir, "warmup_history")
    s = device_session({"spark.rapids.obs.historyDir": hist})
    s.create_or_replace_temp_view("lineitem", DataFrame(h1.li.plan, s))
    want_sql = [s.sql(AUDIT_WARMUP_SQL).collect() for _ in range(2)][-1]
    _obs_teardown()
    first_ms, wdoc = {}, None
    for mode in ("warmup", "cold"):
        CC.clear()
        warmup.reset_for_tests()
        conf = {"spark.rapids.obs.historyDir": hist}
        if mode == "warmup":
            conf["spark.rapids.compile.warmup.enabled"] = "true"
        s = device_session(conf)
        s.create_or_replace_temp_view("lineitem", DataFrame(h1.li.plan, s))
        if mode == "warmup":
            mgr = warmup.manager()
            if mgr is None or not mgr.wait(300):
                problems.append("warmup did not arm or drain")
            wdoc = warmup.doc()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = s.sql(AUDIT_WARMUP_SQL).collect()
        torch.cuda.synchronize()
        first_ms[mode] = (time.perf_counter() - t0) * 1e3
        if not got.sort_by("l_returnflag").equals(
                want_sql.sort_by("l_returnflag")):
            problems.append(f"warmup ({mode}): the answer differs")
        _obs_teardown()
    warmup.reset_for_tests()
    emit({"phase": "audit.warmup", "doc": wdoc,
          "first_query_ms_warmup": first_ms["warmup"],
          "first_query_ms_cold": first_ms["cold"], "card": card})
    if not wdoc or wdoc["replayed"] < 1 or wdoc["failed"]:
        problems.append(f"warmup {wdoc}")

    # -- spark.rapids.profile.dir ---------------------------------------------
    prof_dir = os.path.join(tmp_dir, "audit_profile")
    s = device_session({**SHUFFLED_JOIN, "spark.rapids.profile.dir":
                        prof_dir})
    H.repart_agg(api, DataFrame(h8.li.plan, s)).collect()
    path = s.last_profile_path
    names = set()
    try:
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    except (OSError, TypeError, ValueError, KeyError) as e:
        problems.append(f"profile dir trace {path}: {e}")
    kernels_named = sorted(k for k in ("murmur3", "segsum", "bitslice",
                                       "case_map")
                           if any(k in n for n in names))
    emit({"phase": "audit.profile_dir", "path": path,
          "bytes": os.path.getsize(path) if path else None,
          "events": len(names), "kernels_named": kernels_named})
    if not kernels_named:
        problems.append("the profile dir's trace names no hand kernel")

    # -- the compile counters against phase_build -----------------------------
    st = CC.stats()
    s = device_session()
    reg = obs.state().registry
    counters = {
        "stats": {k: st[k] for k in ("xla_compiles", "xla_compile_ns",
                                     "persistent_hits",
                                     "persistent_misses")},
        "built_in_phase_build": sorted(built),
        "libraries_loaded": sorted(_build._libs),
        "registry": {n: reg.counter(n).value for n in (
            "rapids_xla_compiles_total",
            "rapids_persistent_cache_hits_total",
            "rapids_persistent_cache_misses_total")},
        "healthz_compile": obs.healthz()["compile"]}
    emit({"phase": "audit.compile_counters", **counters})
    if st["xla_compiles"] != len(built) \
            or st["persistent_misses"] != len(built) \
            or st["persistent_hits"] != len(_build._libs) \
            or counters["registry"]["rapids_xla_compiles_total"] \
            != len(built):
        problems.append(f"compile counters {counters}")
    _obs_teardown()

    # -- windows and joins through the dispatch choke point -------------------
    seen = []
    s = device_session()
    small_li = s.create_dataframe(li)
    small_od = s.create_dataframe(od_small)
    fuse.set_dispatch_hook(seen.append)
    try:
        dispatch_lines = {}
        for name, build in (
                ("q67win", lambda: H.q67win(api, small_li)),
                ("running_by_flags", lambda: _running_by_flags(api,
                                                               small_li)),
                ("win_running", lambda: H.win_running(api, small_li)),
                ("q3join", lambda: H.q3join(api, small_li, small_od))):
            del seen[:]
            build().collect()
            fams = {}
            for k in seen:
                if k and k[0] in WINDOW_JOIN_FAMILIES:
                    fams[k[0]] = fams.get(k[0], 0) + 1
            dispatch_lines[name] = fams
    finally:
        fuse.set_dispatch_hook(None)
    emit({"phase": "audit.window_join_dispatches",
          "stage_dispatches": dispatch_lines})
    got_fams = set().union(*[set(v) for v in dispatch_lines.values()])
    if not {"window_sortlay", "window_fns", "window_packed", "window",
            "dense_probe_masked"} <= got_fams:
        problems.append(f"window/join dispatches {dispatch_lines}")
    KA.reset_for_tests(drop_records=True)
    launches = read_launches()
    emit({"phase": "audit", "launches": launches, "correct": not problems,
          "problems": problems, "seconds": time.perf_counter() - t_phase,
          "card": card})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 18: the query runtime
# ---------------------------------------------------------------------------

RT_SMALL_ROWS = 5_000_000
#: the degradation queries' lines: the CPU backend's q6 over 5M lines took
#: 10.8-12.8 s a run on the H100 machine's host (4 runs a phase)
RT_DEGRADE_ROWS = 500_000


def small_reference(small):
    """q1 over the first RT_SMALL_ROWS lines; q6 and q72shfl over the
    first RT_DEGRADE_ROWS."""
    tiny = small.slice(0, RT_DEGRADE_ROWS)
    k = np.mod(tiny["l_orderkey"].to_numpy(), 100_000)
    q = tiny["l_quantity"].to_numpy()
    sums = np.bincount(k, weights=q, minlength=100_000)
    counts = np.bincount(k, minlength=100_000)
    return {"q1": q1_reference(small), "q6": q6_reference(tiny),
            "q72shfl": (int((counts > 0).sum()), round(float(sums.sum()), 2),
                        int(counts.sum()))}


def spill_metrics():
    from spark_rapids_tpu_torch.runtime.memory import peek_spill_framework
    fw = peek_spill_framework()
    return fw.metrics_snapshot() if fw is not None else {}


def spill_report(after: str) -> None:
    """The spill framework's counters and tiers after a phase (every
    phase runs at the JAX package's default budget, 12 GiB)."""
    from spark_rapids_tpu_torch.runtime.memory import peek_spill_framework
    fw = peek_spill_framework()
    if fw is None:
        emit({"phase": "spill", "after": after, "framework": None})
        return
    with fw._lock:
        handles = list(fw._handles.values())
    tiers = {}
    for h in handles:
        tiers[h.tier] = tiers.get(h.tier, 0) + 1
    emit({"phase": "spill", "after": after, **fw.metrics_snapshot(),
          "device_budget": fw.device_budget, "handles": len(handles),
          "tiers": tiers, "device_bytes_held": fw.device_bytes_held()})


class RuntimeChecks:
    """What every runtime query must leave behind: every semaphore permit
    back, no cancel token, and no spillable handle beyond the live
    caches' partitions."""

    def __init__(self, caches):
        self.caches = caches

    def expected_live(self) -> int:
        return sum(len(df.plan.materialized) for df in self.caches
                   if df.plan.materialized is not None)

    def __call__(self, name):
        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        from spark_rapids_tpu_torch.runtime.memory import (
            peek_spill_framework,
        )
        from spark_rapids_tpu_torch.runtime.semaphore import peek_semaphore
        gc.collect()
        out = []
        sem = peek_semaphore()
        if sem is not None and (sem.available != sem.permits
                                or sem.waiting):
            out.append(f"{name}: semaphore {sem.available}/{sem.permits} "
                       f"available, {sem.waiting} waiting")
        if LC.token_ids():
            out.append(f"{name}: cancel tokens left {LC.token_ids()}")
        fw = peek_spill_framework()
        leaks = fw.leak_report(self.expected_live()) if fw else []
        if leaks:
            out.append(f"{name}: {len(leaks)} spillable handles beyond the "
                       f"{self.expected_live()} cached partitions")
        return out


def rt_conf(spill_dir, **extra):
    """A runtime query's conf: disk spills go under the run's temporary
    directory."""
    return {"spark.rapids.memory.spillDir": spill_dir, **extra}


def phase_runtime(want, small, swant, h1, h8, pq_path, tmp_dir, caches,
                  spy):
    """The runtime queries (see the module docstring, phase 18), each
    checked against the answers the earlier phases hold, with the
    semaphore, the cancel tokens and the spill handles checked after
    each."""
    import torch
    from spark_rapids_tpu_torch.runtime import watchdog as WD
    from spark_rapids_tpu_torch.runtime.memory import SpillableHandle
    from spark_rapids_tpu_torch.runtime.semaphore import get_semaphore
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    t_phase = time.perf_counter()
    spill_dir = os.path.join(tmp_dir, "spill")
    check = RuntimeChecks(caches)
    gc.collect()
    problems = check("runtime start")
    reset_launches()
    spy.take()

    def li8(session):
        return DataFrame(h8.li.plan, session)

    def li1(session):
        return DataFrame(h1.li.plan, session)

    def run(name, fn, runs=3, note=None, session=None):
        """Cold then warm runs of fn; one runtime.query line. Returns
        (answers, warm ms, launches a run, the spill counters' change)."""
        before_l, before_s = read_launches(), spill_metrics()
        torch.cuda.reset_peak_memory_stats()
        answers, secs = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            answers.append(fn())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        after_s = spill_metrics()
        launches = {k: (v - before_l[k]) // runs
                    for k, v in read_launches().items()}
        spilled = {k: after_s.get(k, 0) - before_s.get(k, 0)
                   for k in after_s}
        line = {"phase": "runtime.query", "query": name,
                "cold_ms": secs[0] * 1e3,
                "warm_ms": min(secs[1:]) * 1e3 if runs > 1 else None,
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches_per_run": launches,
                "routes": {k: v // runs for k, v in spy.take().items()},
                "spill": spilled}
        if session is not None:
            line["status"] = session.last_action_status
            line["task_metrics"] = session.last_task_metrics()
        line.update(note or {})
        emit(line)
        problems.extend(check(name))
        return answers, line

    # rt_paged_q1: q1 over the 8-partition cache under half its bytes
    li8_bytes = sum(sb.size for part in h8.li.plan.materialized
                    for sb in part)
    s = device_session(rt_conf(spill_dir, **{
        "spark.rapids.memory.tpu.budgetBytes": li8_bytes // 2}))
    q1 = port_queries(li8(s))["q1"]
    answers, line = run("rt_paged_q1", q1, session=s, note={
        "budget_bytes": li8_bytes // 2, "registered_bytes": li8_bytes,
        "unpaged_q1_warm_ms": RUN_NOTES.get("path_q1_warm_ms")})
    if not all(validate("q1", a, want["q1"]) for a in answers):
        problems.append("rt_paged_q1 answer")
    if line["spill"].get("spill_count", 0) < 3:
        problems.append(f"rt_paged_q1 paged {line['spill']}")

    # rt_disk_cascade: q6 over the 8-partition cache, the host store
    # below one partition, so partitions go to the disk and come back
    part_bytes = max(sb.size for part in h8.li.plan.materialized
                     for sb in part)
    disk_reads = [0]
    orig_get = SpillableHandle.get

    def counted_get(self):
        if self.tier == "disk":
            with SPY_LOCK:
                disk_reads[0] += 1
        return orig_get(self)

    SpillableHandle.get = counted_get
    try:
        s = device_session(rt_conf(spill_dir, **{
            "spark.rapids.memory.tpu.budgetBytes": li8_bytes // 2,
            "spark.rapids.memory.host.spillStorageSize": part_bytes // 2}))
        q6 = port_queries(li8(s))["q6"]
        t0 = time.perf_counter()
        answers, line = run("rt_disk_cascade", q6, runs=2, session=s,
                            note={"host_budget_bytes": part_bytes // 2})
        emit({"phase": "runtime.disk", "seconds": time.perf_counter() - t0,
              "disk_reads": disk_reads[0]})
    finally:
        SpillableHandle.get = orig_get
    if not all(_close(a, want["q6"]) for a in answers):
        problems.append("rt_disk_cascade answer")
    if line["spill"].get("spill_to_disk_bytes", 0) <= 0 or not disk_reads[0]:
        problems.append(f"rt_disk_cascade: disk {line['spill']}, "
                        f"{disk_reads[0]} reads from the disk")

    # rt_split_q1: q1 over the 1-partition cache, split once, then three
    # injected retries; q72shfl beside it, split and unsplit (B2)
    base = device_session(rt_conf(spill_dir))
    run("rt_unsplit_q1", port_queries(li1(base))["q1"], runs=2,
        session=base)
    for name, extra, key, n in (
            ("rt_split_q1", {"spark.rapids.sql.test.injectRetryOOM":
                             "1,0,split"}, "splitAndRetryCount", 1),
            ("rt_retry_q1", {"spark.rapids.debug.faults": "retry.oom:oom:3"},
             "retryCount", 3)):
        s = device_session(rt_conf(spill_dir, **extra))
        answers, line = run(name, port_queries(li1(s))["q1"], runs=1,
                            session=s)
        if not validate("q1", answers[0], want["q1"]):
            problems.append(f"{name} answer")
        if line["task_metrics"].get(key) != n:
            problems.append(f"{name}: {key} {line['task_metrics']}")
    _, unsplit = run("rt_unsplit_q72shfl", port_queries(li1(base))["q72shfl"],
                     runs=2, session=base)
    s = device_session(rt_conf(spill_dir, **{
        "spark.rapids.sql.test.injectRetryOOM": "1,0,split"}))
    answers, line = run("rt_split_q72shfl", port_queries(li1(s))["q72shfl"],
                        runs=1, session=s, note={
                            "unsplit_segsum": unsplit["launches_per_run"][
                                "segsum"]})
    if not validate("q72shfl", answers[0], want["q72shfl"]) \
            or line["task_metrics"].get("splitAndRetryCount") != 1 \
            or not line["launches_per_run"]["segsum"]:
        problems.append(f"rt_split_q72shfl {line}")

    # rt_real_oom: a real torch.OutOfMemoryError inside the aggregate's
    # attempt; the retry drains the spill framework (a registered ballast
    # goes to the host) and answers
    problems.extend(rt_real_oom(want, spill_dir, li1, check))

    # rt_wave_repart: repart_agg over the 8-partition cache under
    # concurrentTpuTasks = 2; its exchange runs the cache partitions one
    # after another
    sem = get_semaphore()
    s = device_session(rt_conf(spill_dir))
    sem.reset_peak()
    answers, line = run("rt_wave_repart", port_queries(li8(s))["repart_agg"],
                        session=s, note={"permits": sem.permits})
    emit({"phase": "runtime.wave", "query": "rt_wave_repart",
          "most_tasks_on_device": sem.peak_held, "permits": sem.permits,
          "semaphoreWaitTime_ms": line["task_metrics"].get(
              "semaphoreWaitTime", 0) / 1e6})
    if not all(validate("repart_agg", a, want["repart_agg"])
               for a in answers):
        problems.append("rt_wave_repart answer")
    if sem.permits != 2 or not 1 <= sem.peak_held <= 2:
        problems.append(f"rt_wave_repart: {sem.peak_held} tasks held the "
                        f"device at once under {sem.permits} permits")
    if not (line["launches_per_run"]["murmur3_int32"]
            and line["launches_per_run"]["segsum"]):
        problems.append(f"rt_wave_repart launches {line}")

    # rt_wave_pctl: pctl_shuffled over the 8-partition cache; its
    # aggregate runs once per exchange partition, so the collect's 8
    # partitions are one task wave, 2 at a time on the card
    s = device_session(rt_conf(spill_dir))
    sem.reset_peak()
    answers, line = run("rt_wave_pctl", lambda: helpers().pctl_shuffled(
        port_api(), li8(s)).collect(), session=s,
        note={"permits": sem.permits})
    emit({"phase": "runtime.wave", "query": "rt_wave_pctl",
          "most_tasks_on_device": sem.peak_held, "permits": sem.permits,
          "semaphoreWaitTime_ms": line["task_metrics"].get(
              "semaphoreWaitTime", 0) / 1e6})
    pwant = RUN_NOTES.get("pctl_shuffled_want")
    if pwant is None or not all(validate_exprs("pctl_shuffled", a, pwant)
                                for a in answers):
        problems.append("rt_wave_pctl answer")
    if sem.peak_held != 2:
        problems.append(f"rt_wave_pctl: {sem.peak_held} tasks held the "
                        f"device at once under {sem.permits} permits")
    if not line["launches_per_run"]["murmur3_int32"]:
        problems.append(f"rt_wave_pctl launches {line}")

    problems.extend(rt_admission(want, li1, spill_dir, run))
    problems.extend(rt_quota(want, small, swant, h1, li1, spill_dir, run,
                             check))
    problems.extend(rt_cancel_scan(want, pq_path, spill_dir, run, check))
    problems.extend(rt_degrade(small, swant, spill_dir, run, check))
    counts = read_launches()
    emit({"phase": "runtime", "seconds": time.perf_counter() - t_phase,
          "launches": counts, "spill": spill_metrics(),
          "breaker": WD.peek_breaker().state_doc()
          if WD.peek_breaker() else None,
          "correct": not problems, "problems": problems})
    if problems:
        raise AssertionError("; ".join(problems))
    if min(counts[k] for k in ("murmur3_int32", "segsum", "bitslice")) <= 0:
        raise AssertionError(f"a kernel did not run in the runtime phase: "
                             f"{counts}")
    return counts


def plug_free_blocks(floor: int = 1 << 20) -> list:
    """Tensors that take the free space inside the caching allocator's
    reserved segments (largest first, halving on a failed allocation
    down to ``floor``), so that under a cap at the reserved bytes only
    the cap's margin is left to allocate from."""
    import torch
    plugs, size = [], 1 << 30
    while size >= floor:
        try:
            plugs.append(torch.empty(size, dtype=torch.uint8,
                                     device="cuda"))
        except torch.OutOfMemoryError:
            size //= 2
    return plugs


def rt_real_oom(want, spill_dir, li1, check):
    """Caps this process's share of the card just above what it holds,
    with a 4 GiB spillable ballast registered, so q1's update over the
    1-partition cache cannot allocate until the retry's drain moves the
    ballast to the host. The free space left inside the allocator's
    segments by earlier phases is plugged first (under a cap at the
    reserved bytes), then the cap is raised by a margin. The first
    margin at which the failing allocation lands inside the aggregate's
    attempt is the run's setting; the cap is lifted, the plugs freed and
    the ballast closed after each try."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnVector, ColumnarBatch,
    )
    from spark_rapids_tpu_torch.runtime import retry as RR
    from spark_rapids_tpu_torch.runtime.memory import SpillableColumnarBatch
    total = torch.cuda.get_device_properties(0).total_memory
    seen = []
    orig = RR.is_device_oom

    def recorded(e):
        hit = orig(e)
        if hit:
            seen.append(type(e).__name__)
        return hit

    tried = []
    s = device_session(rt_conf(spill_dir, **{
        "spark.rapids.memory.host.spillStorageSize": 64 << 30}))
    q1 = port_queries(li1(s))["q1"]
    q6 = port_queries(li1(s))["q6"]
    RR.is_device_oom = recorded
    try:
        for margin_mb in (64, 128, 256, 512, 1024, 2048):
            n = (4 << 30) // 8
            ballast = SpillableColumnarBatch(ColumnarBatch(
                [ColumnVector(T.INT64, torch.ones(n, dtype=torch.int64,
                                                  device="cuda"))], n))
            q6()  # the cache back on the card before the cap
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            torch.cuda.set_per_process_memory_fraction(reserved / total)
            plugs = plug_free_blocks()
            limit = torch.cuda.memory_reserved() + (margin_mb << 20)
            del seen[:]
            before_l, before_s = read_launches(), spill_metrics()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_per_process_memory_fraction(limit / total)
            err, got = None, None
            t0 = time.perf_counter()
            try:
                got = q1()
            except torch.OutOfMemoryError as e:  # outside the attempt
                err = str(e).splitlines()[0][:160]
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.set_per_process_memory_fraction(1.0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                plugged = sum(p.numel() for p in plugs)
                del plugs
                ballast_tier = ballast.tier
                ballast.close()
                del ballast
                torch.cuda.empty_cache()
            tm = s.last_task_metrics()
            drained = spill_metrics().get("oom_drains", 0) \
                - before_s.get("oom_drains", 0)
            tried.append({"margin_mb": margin_mb, "raised": err,
                          "retryCount": tm.get("retryCount", 0),
                          "errors": list(seen),
                          "plugged_gb": plugged / 2 ** 30})
            if err is None and tm.get("retryCount", 0) >= 1:
                line = {"phase": "runtime.query", "query": "rt_real_oom",
                        "cold_ms": ms, "peak_gb": peak,
                        "launches_per_run": {
                            k: v - before_l[k]
                            for k, v in read_launches().items()},
                        "status": s.last_action_status, "task_metrics": tm,
                        "errors": list(seen), "oom_drains": drained,
                        "margin_mb": margin_mb, "cap_gb": limit / 2 ** 30,
                        "ballast_tier_after": ballast_tier,
                        "tried": tried}
                emit(line)
                out = check("rt_real_oom")
                if not validate("q1", got, want["q1"]):
                    out.append("rt_real_oom answer")
                if "OutOfMemoryError" not in seen or drained < 1 \
                        or ballast_tier != "host":
                    out.append(f"rt_real_oom: {line}")
                return out
    finally:
        RR.is_device_oom = orig
    emit({"phase": "runtime.query", "query": "rt_real_oom", "tried": tried})
    return [f"rt_real_oom: no margin put the failing allocation inside "
            f"the attempt: {tried}"]


def rt_admission(want, li1, spill_dir, run):
    """Four threads run q6 over the 1-partition cache with
    spark.rapids.query.maxConcurrent=1: each query's window, from its
    admission to its release, is recorded, and no two overlap."""
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    s = device_session(rt_conf(spill_dir, **{
        "spark.rapids.query.maxConcurrent": 1}))
    q6 = port_queries(li1(s))["q6"]
    windows, answers = {}, []
    orig_admit, orig_finish = LC.admit, LC.finish_action

    def admit(tok, conf):
        orig_admit(tok, conf)
        windows[tok.query_id] = [time.monotonic(), None]

    def finish(tok, status):
        if tok is not None and tok.query_id in windows:
            windows[tok.query_id][1] = time.monotonic()
        orig_finish(tok, status)

    def worker():
        answers.append(q6())

    LC.admit, LC.finish_action = admit, finish
    try:
        def four():
            ths = [threading.Thread(target=worker) for _ in range(4)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)
            return len(answers)
        run("rt_admission", four, runs=1)
    finally:
        LC.admit, LC.finish_action = orig_admit, orig_finish
    spans = sorted(windows.values())
    overlaps = sum(1 for a, b in zip(spans, spans[1:]) if b[0] < a[1])
    emit({"phase": "runtime.admission", "queries": len(spans),
          "windows_ms": [[(a - spans[0][0]) * 1e3, (b - spans[0][0]) * 1e3]
                         for a, b in spans], "overlaps": overlaps})
    out = []
    if len(answers) != 4 or not all(_close(a, want["q6"]) for a in answers):
        out.append(f"rt_admission answers {answers}")
    if len(spans) != 4 or overlaps:
        out.append(f"rt_admission windows {spans}")
    return out


def rt_quota(want, small, swant, h1, li1, spill_dir, run, check):
    """Session A caches the first 5M lines in 4 partitions under a query
    quota of 1.6 partitions and runs q1 over them (its own handles
    spill); at the same time session B runs q6 over the 1-partition
    cache, whose partition stays on the card throughout."""
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    from spark_rapids_tpu_torch.runtime.memory import SpillableHandle
    per_part = from_arrow(small.slice(0, small.num_rows // 4),
                          h1.s.device).device_memory_size()
    quota = int(per_part * 1.6)
    sb = device_session(rt_conf(spill_dir))
    q6 = port_queries(li1(sb))["q6"]
    q6()  # the 1-partition cache back on the card
    handle = h1.li.plan.materialized[0][0].handle
    sa = device_session(rt_conf(spill_dir, **{
        "spark.rapids.query.deviceBudgetBytes": quota}))
    a_df = sa.create_dataframe(small, num_partitions=4).cache()
    q1 = port_queries(a_df)["q1"]
    victims, tiers, box = [], set(), {}
    orig = SpillableHandle.spill_to_host

    def tracked(self):
        freed = orig(self)
        if freed:
            with SPY_LOCK:
                victims.append(self.query_id)
        return freed

    stop = threading.Event()

    def watch():
        while not stop.is_set():
            tiers.add(handle.tier)
            time.sleep(0.0005)

    def side(name, fn):
        try:
            box[name] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            box[name] = e

    def both():
        ths = [threading.Thread(target=side, args=("a", q1)),
               threading.Thread(target=side, args=("b", q6))]
        w = threading.Thread(target=watch)
        w.start()
        for th in ths:
            th.start()
        for th in ths:
            th.join(300)
        stop.set()
        w.join()
        return box

    SpillableHandle.spill_to_host = tracked
    check.caches.append(a_df)
    try:
        run("rt_quota", both, runs=1, note={
            "quota_bytes": quota, "partition_bytes": per_part})
    finally:
        SpillableHandle.spill_to_host = orig
        check.caches.remove(a_df)
    a_tiers = [p[0].tier for p in a_df.plan.materialized]
    emit({"phase": "runtime.quota", "spill_victims": len(victims),
          "victim_queries": sorted(set(map(str, victims))),
          "a_partition_tiers": a_tiers, "b_partition_tiers": sorted(tiers)})
    out = []
    if not isinstance(box.get("a"), dict) \
            or not validate("q1", box["a"], swant["q1"]):
        out.append(f"rt_quota A answer {box.get('a')!r:.200}")
    if not isinstance(box.get("b"), float) \
            or not _close(box["b"], want["q6"]):
        out.append(f"rt_quota B answer {box.get('b')!r:.200}")
    if not victims or len(set(victims)) != 1 or tiers != {"device"}:
        out.append(f"rt_quota: victims {victims}, B's tiers {tiers}")
    del a_df, sa, q1
    gc.collect()
    out.extend(check("rt_quota after A's cache is dropped"))
    return out


def rt_cancel_scan(want, pq_path, spill_dir, run, check):
    """pq_q1_mixed (the device-decode scan) cancelled 0.5 s in from
    another thread, then under a 0.3 s deadline, then to its answer."""
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    out = []
    s = device_session(rt_conf(spill_dir))
    q1 = port_queries(s.read_parquet(pq_path, columns=Q1_COLS))["q1"]
    box = {}

    def victim():
        box["t0"] = time.monotonic()
        try:
            box["got"] = q1()
        except LC.QueryCancelledError as e:
            box["raised_at"] = time.monotonic()
            box["error"] = e
        box["ended"] = time.monotonic()

    th = threading.Thread(target=victim)
    th.start()
    deadline = time.monotonic() + 60
    while not LC.token_ids() and time.monotonic() < deadline:
        time.sleep(0.001)
    qid = LC.token_ids()[0]
    time.sleep(max(0.0, box["t0"] + 0.5 - time.monotonic()))
    t_cancel = time.monotonic()
    fired = s.cancel(qid)
    th.join(120)
    latency = box.get("raised_at", float("nan")) - t_cancel
    line = {"phase": "runtime.query", "query": "rt_cancel_scan",
            "cancelled": fired, "error": type(box.get("error")).__name__,
            "status": s.last_action_status,
            "cancel_to_raise_ms": latency * 1e3,
            "cancel_after_ms": (t_cancel - box["t0"]) * 1e3,
            "query_ms": (box.get("ended", float("nan")) - box["t0"]) * 1e3}
    emit(line)
    if not fired or "error" not in box \
            or s.last_action_status != ("cancelled", "user"):
        out.append(f"rt_cancel_scan: {line}")
    out.extend(check("rt_cancel_scan"))
    sd = device_session(rt_conf(spill_dir, **{
        "spark.rapids.query.timeoutSeconds": 0.3}))
    qd = port_queries(sd.read_parquet(pq_path, columns=Q1_COLS))["q1"]
    t0 = time.monotonic()
    try:
        qd()
        raised = None
    except LC.QueryCancelledError as e:
        raised = e.reason
    emit({"phase": "runtime.query", "query": "rt_deadline_scan",
          "raised": raised, "status": sd.last_action_status,
          "ended_ms": (time.monotonic() - t0) * 1e3})
    if raised != "deadline" or sd.last_action_status != ("cancelled",
                                                          "deadline"):
        out.append(f"rt_deadline_scan: {raised} {sd.last_action_status}")
    out.extend(check("rt_deadline_scan"))
    answers, line = run("rt_rerun_scan", q1, runs=2, session=s)
    if not all(validate("q1", a, want["q1"]) for a in answers) \
            or not line["launches_per_run"]["bitslice"] \
            or s.last_action_status != ("ok", None):
        out.append(f"rt_rerun_scan: {line}")
    return out


def rt_degrade(small, swant, spill_dir, run, check):
    """With spark.rapids.fallback.cpu.enabled: an injected scan fault
    degrades q6 over the first RT_DEGRADE_ROWS lines in memory to the
    CPU backend;
    three such failures open the breaker and the next query skips the
    card; after the backoff a probe query runs on the card; an ANSI
    divide by zero still fails. The breaker's backoff is set from the
    first CPU re-execution's time (2.5x it, plus 2 s), so the skipped
    query, itself a CPU run, lands inside it on any host."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.expr.core import SparkException, col
    from spark_rapids_tpu_torch.runtime import faults
    from spark_rapids_tpu_torch.runtime import watchdog as WD
    out = []
    WD.uninstall_for_tests()  # a fresh breaker: closed, no failures
    conf = rt_conf(spill_dir, **{
        "spark.rapids.fallback.cpu.enabled": "true",
        "spark.rapids.watchdog.breakerFailureThreshold": 3,
        "spark.rapids.watchdog.breakerBaseBackoffSeconds": 60.0,
        "spark.rapids.debug.faults": "scan.decode:ioerror:99"})
    s = device_session(conf)
    df = s.create_dataframe(small.slice(0, RT_DEGRADE_ROWS))
    q6 = port_queries(df)["q6"]
    backoff = None
    for i in range(3):
        answers, line = run(f"rt_degrade_{i + 1}", q6, runs=1, session=s,
                            note={"breaker": WD.breaker().state})
        if not _close(answers[0], swant["q6"]) \
                or s.last_action_status != ("degraded",
                                            "InjectedFaultError"):
            out.append(f"rt_degrade_{i + 1}: {line}")
        if i == 0:
            # taken by the breaker at the next query's preamble, while it
            # is still closed
            backoff = 2.5 * line["cold_ms"] / 1e3 + 2.0
            s.conf.set("spark.rapids.watchdog.breakerBaseBackoffSeconds",
                       backoff)
    fired = faults.total_fired()
    answers, line = run("rt_circuit_open", q6, runs=1, session=s,
                        note={"breaker": WD.breaker().state,
                              "backoff_s": backoff})
    if not _close(answers[0], swant["q6"]) \
            or s.last_action_status != ("degraded", "circuit_open") \
            or faults.total_fired() != fired \
            or any(line["launches_per_run"].values()):
        out.append(f"rt_circuit_open: {line}")
    open_for = WD.breaker().state_doc().get("open_for_s", 0.0)
    time.sleep(max(0.0, backoff - open_for) + 0.05)  # the backoff
    s.conf.set("spark.rapids.debug.faults", "")
    answers, line = run("rt_probe", port_queries(df)["q72shfl"], runs=1,
                        session=s)
    state = WD.breaker().state
    emit({"phase": "runtime.breaker", "after_probe": state,
          "doc": WD.breaker().state_doc()})
    if not validate("q72shfl", answers[0], swant["q72shfl"]) \
            or s.last_action_status != ("ok", None) or state != "closed" \
            or not line["launches_per_run"]["segsum"]:
        out.append(f"rt_probe: {line} breaker {state}")
    sa = device_session(rt_conf(spill_dir, **{
        "spark.rapids.fallback.cpu.enabled": "true",
        "spark.sql.ansi.enabled": "true"}))
    bad = sa.create_dataframe(pa.table({"a": [1, 2, 3], "b": [1, 0, 2]})) \
        .select((col("a") / col("b")).alias("q"))
    try:
        bad.collect()
        raised = None
    except SparkException as e:
        raised = str(e)[:120]
    emit({"phase": "runtime.query", "query": "rt_ansi_fails",
          "raised": raised, "status": sa.last_action_status})
    if raised is None or sa.last_action_status != ("failed", None):
        out.append(f"rt_ansi_fails: {raised} {sa.last_action_status}")
    out.extend(check("rt_ansi_fails"))
    return out


#: launch-counter name -> (wrapper module, wrapper function, a substring
#: of the CUDA kernel's name as the profiler reports it)
KERNEL_WRAPPERS = {
    "murmur3_int32": ("murmur3_kernel", "murmur3_int32", "murmur3"),
    "segsum": ("segsum", "segsum", "segsum"),
    "bitslice": ("bitslice", "bitslice", "bitslice"),
    "case_map": ("case_map", "case_map", "case_map"),
}


def launch_bytes(name, *a):
    """The bytes one launch must move, from the operands it was given:
    each input read once, each output written once. For bitslice, the
    words its fields lie in, from the offsets' maximum: a 0-d tensor on
    the card, read after the profiled run."""
    if name == "murmur3_int32":
        values, seed = a
        return values.numel() * (12 if hasattr(seed, "numel") else 8)
    if name == "segsum":
        gid, payload, outcap = a
        return gid.numel() * 4 + payload.numel() * 2 \
            + outcap * payload.shape[0] * 4
    if name == "bitslice":
        words, bitoff, _ = a
        if not bitoff.numel():
            return 0
        return bitoff.numel() * 16 + 4 * (bitoff.max() // 32 + 2).clamp(
            max=words.numel())
    raw, _ = a
    return 2 * raw.numel()


class KernelProfile:
    """CHIP_SMOKE_PROFILE=1: one warm run of each query of every path under
    torch.profiler, after the path's checks. Per query: the device time
    summed over CUDA kernels beside the host wall time, the kernels taking
    the most device time, and per port kernel its launches in that run,
    their device time and the sum of their bounds at the shapes the query
    gave them. ``rank`` sums the last over all profiled queries: device
    time above bound at the shapes the paths really launch (set
    CHIP_SMOKE_TRACE_DIR to also write each query's Chrome trace). A
    kernel whose launches the profiler did not all record, twice, is left
    out of the sums for that query and marked incomplete."""

    def __init__(self):
        self.totals = {k: {"launches": 0, "profiled_calls": 0,
                           "device_ms": 0.0, "bound_ms": 0.0,
                           "launches_without_time": 0, "incomplete": False,
                           "launches_by_path": {}}
                       for k in KERNEL_WRAPPERS}
        self.out_dir = os.environ.get("CHIP_SMOKE_TRACE_DIR")
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)

    @staticmethod
    def _record_launches(sizes):
        """Wraps the kernel wrappers (every caller reaches them through
        their module) so each launch appends its bytes to sizes[name];
        returns the function that puts the originals back."""
        import importlib
        restore = []
        for name, (mod_name, fn_name, _) in KERNEL_WRAPPERS.items():
            mod = importlib.import_module(
                f"spark_rapids_tpu_torch.ops.{mod_name}")
            orig = getattr(mod, fn_name)

            def spy(*a, _mod=mod, _orig=orig, _name=name):
                # the launch count moves under this lock only: a launch
                # of another task's thread is not this call's
                with SPY_LOCK:
                    before = _mod.launches
                    out = _orig(*a)
                    launched = _mod.launches != before
                if launched:
                    sizes[_name].append(launch_bytes(_name, *a))
                return out
            setattr(mod, fn_name, spy)
            restore.append((mod, fn_name, orig))

        def undo():
            for mod, fn_name, orig in restore:
                setattr(mod, fn_name, orig)
        return undo

    def _profile(self, name, fn):
        """One traced warm run of fn: (wall ms, [(device ms, kernel,
        calls)] largest first, {kernel wrapper: [bytes per launch]})."""
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        fn()
        torch.cuda.synchronize()
        sizes = {k: [] for k in KERNEL_WRAPPERS}
        events = []

        def ready(p):
            events.extend(p.key_averages())
            if self.out_dir:
                p.export_chrome_trace(os.path.join(
                    self.out_dir, f"trace_{name}.json"))
        # a traced warm-up run that is dropped: the first kernels after
        # the tracer starts can go unrecorded
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            undo = self._record_launches(sizes)
            try:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                undo()
            prof.step()
        rows = []
        for e in events:
            if "CUDA" not in str(getattr(e, "device_type", "")) \
                    or e.key.startswith(("ProfilerStep",) + STAGE_RANGES):
                # host-side ops, and the step's and the fused stages' own
                # annotations on the card, would count their kernels twice
                continue
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) / 1e3
            if dev > 0:
                rows.append((dev, e.key, e.count))
        rows.sort(reverse=True)
        return wall_ms, rows, sizes

    @staticmethod
    def _kernels(rows, sizes):
        kernels = {}
        for k, (_, _, match) in KERNEL_WRAPPERS.items():
            if sizes[k]:
                kernels[k] = {
                    "launches": len(sizes[k]),
                    "profiled_calls": sum(r[2] for r in rows
                                          if match in r[1]),
                    "device_ms": sum(r[0] for r in rows if match in r[1]),
                    "bound_ms": sum(float(b) for b in sizes[k])
                    / HBM_BYTES_PER_S * 1e3}
        return kernels

    def run(self, path, queries) -> None:
        """Profile each query once; a query in which the profiler recorded
        fewer calls of a port kernel than it launched is profiled once
        more. If calls are still missing, that kernel's time and bound in
        that query stay out of the totals (its launches count) and both
        its line and its rank row say "incomplete": no share of bound
        rests on a launch that has no time."""
        for name, fn in queries.items():
            wall_ms, rows, sizes = self._profile(name, fn)
            kernels = self._kernels(rows, sizes)
            retried = False
            if any(v["profiled_calls"] < v["launches"]
                   for v in kernels.values()):
                retried = True
                wall_ms, rows, sizes = self._profile(name, fn)
                kernels = self._kernels(rows, sizes)
            for k, got in kernels.items():
                tot = self.totals[k]
                tot["launches"] += got["launches"]
                by_path = tot["launches_by_path"]
                by_path[path] = by_path.get(path, 0) + got["launches"]
                if got["profiled_calls"] < got["launches"]:
                    got["incomplete"] = True
                    tot["incomplete"] = True
                    tot["launches_without_time"] += got["launches"]
                    continue
                for f in ("profiled_calls", "device_ms", "bound_ms"):
                    tot[f] += got[f]
            device_ms = sum(r[0] for r in rows)
            emit({"phase": "profile", "path": path, "query": name,
                  "wall_ms": wall_ms, "device_ms": device_ms,
                  "device_idle_share": (max(0.0, 1 - device_ms / wall_ms)
                                        if device_ms else None),
                  "profiled_twice": retried, "kernels": kernels,
                  "top": [{"kernel": k[:80], "ms": d, "calls": c}
                          for d, k, c in rows[:8]]})

    def rank(self) -> None:
        """The kernels by device time above bound over one profiled run of
        every query, largest first."""
        out = sorted(({"name": k, **v,
                       "above_bound_ms": v["device_ms"] - v["bound_ms"],
                       "share_of_bound": (v["bound_ms"] / v["device_ms"]
                                          if v["device_ms"] else None)}
                      for k, v in self.totals.items()),
                     key=lambda r: -r["above_bound_ms"])
        emit({"phase": "profile.rank", "kernels": out})


def shuffle_alone() -> int:
    """--phase shuffle: the build, the setup, the joins phase's
    8-partition caches and the shuffle phase alone (no kernels line)."""
    from types import SimpleNamespace

    import torch
    print(nvidia_smi(), flush=True)
    tmp_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_build()
        table, orders, want, _ = phase_setup(ROWS, tmp_dir)
        t0 = time.perf_counter()
        s8 = device_session(SHUFFLED_JOIN)
        h8 = SimpleNamespace(s=s8, li=s8.create_dataframe(
            table, num_partitions=8).cache(), od=s8.create_dataframe(
            orders, num_partitions=8).cache())
        counts = [h8.li.count(), h8.od.count()]
        torch.cuda.synchronize()
        emit({"phase": "shuffle.caches", "counts": counts,
              "cache_s": time.perf_counter() - t0})
        phase_shuffle(table, orders, want, h8, tmp_dir, RouteSpy())
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return 0


def main(argv) -> int:
    from types import SimpleNamespace

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if argv:
        if argv == ["--phase", "shuffle"]:
            return shuffle_alone()
        if argv[0] != "--segsum-against" or len(argv) < 2:
            print("usage: chip_smoke.py [--segsum-against SOURCE.cu ... | "
                  "--phase shuffle]", file=sys.stderr)
            return 2
        return compare_segsum(argv[1:])
    card = nvidia_smi()
    print(card, flush=True)
    t_all = time.perf_counter()
    phases = {}
    tmp_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        built = phase_build()
        phases["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        table, orders, want, path = phase_setup(ROWS, tmp_dir)
        text = helpers().lineitem_text(table)
        phases["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = phase_kernels(path, comment_plane(text))
        phases["kernels_s"] = time.perf_counter() - t0
        spy = RouteSpy()
        prof = KernelProfile() \
            if os.environ.get("CHIP_SMOKE_PROFILE") == "1" else None
        t0 = time.perf_counter()
        cached = phase_path(table, want, spy, prof)
        phases["path_s"] = time.perf_counter() - t0
        spill_report("path")
        t0 = time.perf_counter()
        joins, h1, h8, jwant = phase_joins(table, orders, spy, prof)
        phases["joins_s"] = time.perf_counter() - t0
        spill_report("joins")
        t0 = time.perf_counter()
        adaptive = phase_adaptive(table, orders, want, jwant, h1, h8, spy,
                                  prof)
        phases["adaptive_s"] = time.perf_counter() - t0
        spill_report("adaptive")
        t0 = time.perf_counter()
        window, w1, wwant = phase_window(table, spy, prof)
        phases["window_s"] = time.perf_counter() - t0
        spill_report("window")
        t0 = time.perf_counter()
        sql = phase_sql(table, orders, want, jwant, wwant, h1, h8, w1,
                        tmp_dir, spy, prof)
        phases["sql_s"] = time.perf_counter() - t0
        spill_report("sql")
        # a temp view and its session refer to each other: collect the
        # cycles, so the window slice's cache does not count in the next
        # phases' peak memory
        del w1, jwant, wwant
        gc.collect()
        t0 = time.perf_counter()
        exprs = phase_exprs(table, h1, h8, spy, prof)
        phases["exprs_s"] = time.perf_counter() - t0
        spill_report("exprs")
        t0 = time.perf_counter()
        sets = phase_sets(table, orders, h1, h8, spy, prof)
        phases["sets_s"] = time.perf_counter() - t0
        spill_report("sets")
        t0 = time.perf_counter()
        aggtypes = phase_aggtypes(table, want, h1, h8, spy, prof)
        phases["aggtypes_s"] = time.perf_counter() - t0
        spill_report("aggtypes")
        t0 = time.perf_counter()
        dtime = phase_datetime(table, spy, prof)
        phases["datetime_s"] = time.perf_counter() - t0
        spill_report("datetime")
        t0 = time.perf_counter()
        nested, n1 = phase_nested(table, orders, h1, tmp_dir, spy, prof)
        phases["nested_s"] = time.perf_counter() - t0
        spill_report("nested")
        t0 = time.perf_counter()
        formats = phase_formats(table, orders, want, n1, h1, tmp_dir, spy,
                                prof)
        phases["formats_s"] = time.perf_counter() - t0
        spill_report("formats")
        del n1
        gc.collect()
        t0 = time.perf_counter()
        shuffle = phase_shuffle(table, orders, want, h8, tmp_dir, spy)
        phases["shuffle_s"] = time.perf_counter() - t0
        spill_report("shuffle")
        t0 = time.perf_counter()
        udf = phase_udf(table, h1, h8, spy)
        phases["udf_s"] = time.perf_counter() - t0
        spill_report("udf")
        t0 = time.perf_counter()
        fb_want = fallback_reference(text, table)
        phases["fallback_reference_s"] = time.perf_counter() - t0
        li_plan = h1.li.plan  # the cached lineitem, for the fallback phase
        # the runtime phase's 5M-line slice and its answers; h1 and h8
        # stay cached for it
        small = table.slice(0, RT_SMALL_ROWS)
        swant = small_reference(small)
        t0 = time.perf_counter()
        fwant = fusion_reference(table)
        phases["fusion_reference_s"] = time.perf_counter() - t0
        del table, orders
        gc.collect()
        t0 = time.perf_counter()
        parquet = phase_parquet(path, want, spy, prof)
        phases["parquet_s"] = time.perf_counter() - t0
        spill_report("parquet")
        t0 = time.perf_counter()
        phase_decode(path, tmp_dir, torch.device("cuda"))
        phases["decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline = phase_pipeline(path, want, tmp_dir)
        phases["pipeline_s"] = time.perf_counter() - t0
        spill_report("pipeline")
        t0 = time.perf_counter()
        strings, text_plan = phase_strings(text, spy, prof)
        phases["strings_s"] = time.perf_counter() - t0
        spill_report("strings")
        t0 = time.perf_counter()
        regex = phase_regex(text, text_plan, spy, prof)
        phases["regex_s"] = time.perf_counter() - t0
        spill_report("regex")
        t0 = time.perf_counter()
        fallback = phase_fallback(li_plan, text_plan, fb_want, spy, prof)
        phases["fallback_s"] = time.perf_counter() - t0
        spill_report("fallback")
        del text, fb_want
        gc.collect()
        t0 = time.perf_counter()
        traced = phase_trace(want, h1, h8, path, tmp_dir, spy)
        phases["trace_s"] = time.perf_counter() - t0
        spill_report("trace")
        t0 = time.perf_counter()
        observed = phase_obs(want, h1, h8, path, tmp_dir)
        phases["obs_s"] = time.perf_counter() - t0
        spill_report("obs")
        t0 = time.perf_counter()
        history = phase_history(want, h1, h8, path, tmp_dir)
        phases["history_s"] = time.perf_counter() - t0
        spill_report("history")
        t0 = time.perf_counter()
        fusion = phase_fusion(want, fwant, h1, path, tmp_dir, prof)
        phases["fusion_s"] = time.perf_counter() - t0
        spill_report("fusion")
        t0 = time.perf_counter()
        audit = phase_audit(h1, h8, built, tmp_dir)
        phases["audit_s"] = time.perf_counter() - t0
        spill_report("audit")
        t0 = time.perf_counter()
        caches = [h1.li, h1.od, h1.cust, h8.li, h8.od,
                  SimpleNamespace(plan=text_plan)]
        runtime = phase_runtime(want, small, swant, h1, h8, path, tmp_dir,
                                caches, spy)
        phases["runtime_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    for r in rows:
        by_path = {"cached": cached[r["name"]], "parquet": parquet[r["name"]],
                   "pipeline": pipeline[r["name"]],
                   "strings": strings[r["name"]], "joins": joins[r["name"]],
                   "adaptive": adaptive[r["name"]],
                   "window": window[r["name"]], "sql": sql[r["name"]],
                   "exprs": exprs[r["name"]],
                   "sets": sets[r["name"]], "aggtypes": aggtypes[r["name"]],
                   "datetime": dtime[r["name"]],
                   "nested": nested[r["name"]],
                   "formats": formats[r["name"]],
                   "shuffle": shuffle[r["name"]],
                   "udf": udf[r["name"]],
                   "regex": regex[r["name"]],
                   "fallback": fallback[r["name"]],
                   "trace": traced[r["name"]],
                   "obs": observed[r["name"]],
                   "history": history[r["name"]],
                   "fusion": fusion[r["name"]],
                   "audit": audit[r["name"]],
                   "runtime": runtime[r["name"]]}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    if prof:
        prof.rank()
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "spark_rapids_tpu"))
    if jax_loaded:
        raise AssertionError(f"the run imported {jax_loaded}")
    phases["total_s"] = time.perf_counter() - t_all
    emit({"phase": "done", **phases})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # noqa: BLE001 - any phase failure fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
