#!/usr/bin/env python3
"""Chip smoke test of localai_tpu_torch, the PyTorch/CUDA port: drives the
port's serving paths once on ONE NVIDIA GPU and checks them.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each raising on failure (no phase swallows an error):

  1. setup    require CUDA; print the card's name and power limit; build the
              hand-written kernels from localai_tpu_torch/ops/kernels/csrc/
              with nvcc, one process per source, started together:
              paged_decode.cu (K1 paged decode, K3 the same over int8 pages),
              ragged_prefill.cu (K2 ragged prefill, K2-int8 over int8 pages),
              contig_decode.cu (K4 contiguous decode, K5 the same over the
              stacked cache with a device layer index), quant_matmul.cu
              (W8 / W4, the weight-only int8 / int4 products); beside
              them, the native grammar runtime with g++
              (localai_tpu_torch/functions/grammars/csrc/grammar.cc).
  2. parity   each kernel against its plain PyTorch version on the card at
              Llama-3.1-8B head shapes (KV 8, G 4, hd 128, page 64), in
              float32 and bfloat16: decode lengths 0, 1, around the decode
              kernels' split size (SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS +
              1: 63, 64, 65), 1000, 2500, 4095 over a shuffled page pool (K1,
              and K3 over int8 pages) or a contiguous 4096-row cache (K4; K5
              at layer 2 of 4);
              fresh / continued / pad segments in packs of N = 128, 512,
              1024 tokens (K2, and K2-int8 over int8 pages); all of them
              but K5 again at the 1B draft's head_dim (hd 64). Tolerances:
              float32 atol 1e-4 (sum order); bfloat16 atol 2e-2 and rtol
              2e-2 (bf16 rounding of the plain version's scores,
              probabilities and output, plus order); int8 cases compare
              kernel and plain on the SAME int8 rows, so the same hold.
              W8 and W4 at every Llama-3.1-8B projection shape (K, N) =
              (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 128256) (W4: the layer shapes, g 128) and at (11008,
              4096) with the g pick_int4_group gives at tp 8 (86): bfloat16
              on the tensor-core kernel at M = 1, 8, 9, 15, 16, 17, 64, 65,
              256, 476, 512 (every token tile 8 / 16 / 64 / 128 / 256 and
              its edges, and the long prompt's third chunk), float32 at M =
              1, 8, 16 (the CUDA-core skinny kernel), 17, 512 (dequantize +
              matmul; the tp-8 case at 1, 8, 17), and a tied int8 table
              [128256, 4096] used transposed (dequantize + matmul); at
              the 1B draft's projections (2048, 2048), (2048, 512), (2048,
              8192), (8192, 2048), W8 and W4, M = 1, 8, 40, 512, both
              dtypes, and its tied table [128256, 2048] at M = 1, 8, 40; same
              tolerances (float32: sum order; bfloat16: the kernel widens
              each weight to the plain version's bf16(q * s), so only the
              sum order and the output's bf16 rounding differ). The
              dequantize route's scratch is freed afterwards: the bf16
              serving path below allocates none.
              Then a small model (hd 128, float32) on the card — kernels —
              against the same model on the CPU — plain versions — in the
              five configurations (paged float, paged int8, contiguous,
              int8 weights + int8 KV, int4 weights): prefill and decode
              logits within 1e-3 (int8 KV: 5e-3, since a row may quantize
              one level apart where the card's and the CPU's float32
              projections differ in the last bits). On the same small
              model, in each configuration, the decode step captured as
              CUDA graphs (engine/decode_graph.py: the plain and the full
              sampler variant) against the eager per-step loop, bursts of
              16, 8, 1 and 4 steps with an idle slot: greedy and
              seeded-sampled slots, graph (plain) == eager; the same
              neutral slots through the full variant == the plain graph;
              slots with penalties + a logit bias (greedy), typical-p and
              mirostat (seeded), full graph == full eager. Byte-identical
              ids, logprobs, cache rows and sampler state (counters,
              penalty rings, mirostat mu); the banned token never comes
              out; the decode kernel's launches, counted through the
              replays, are layers x steps on every side. Then, in each
              configuration, the small model's draft of another shape (hd
              64, one layer, tied embeddings) card vs CPU as above, and
              the spec round with that draft captured (its D + 1 steps in
              the graph) against its eager form: 3 rounds, two slots
              speculating (greedy, seeded sampled), ids, n_out, counters
              and draft rows identical, logprobs within 1e-4, the decode
              kernel launched (2 + 5 x 1) x 3 times, K2 / K2-int8 2 x 3.
  3. serving  the port's HTTP server (stdlib) with a Llama-3.1-8B-shaped
              config-only model dir, full width and depth: random bf16
              weights from a seed, 8 slots, context 4096, prefill_chunk 512,
              the engine's loop at its defaults (pipeline_depth 2, the
              split fused tick; phases 3b-3f run on it or on engines
              with its knobs), in five configurations, one after the other:
                paged    bf16 KV, page 64 (the default path): K1 + K2;
                int8     kv_cache_dtype int8, page 64: K3 + K2-int8 (and
                         K2 for fresh packs), no K1;
                contig   kv_layout contiguous, bf16 KV: K4 + K2;
                w8kv8    quantization int8 + kv_cache_dtype int8 (the
                         README's YAML): W8 + K3 + K2-int8 + K2, no W4;
                w4       quantization int4 (lm_head and embed int8), bf16
                         KV: W4 + W8 + K1 + K2.
              The first three keep bf16 weights and launch no W8 / W4; the
              quantized ones are quantized from the seed's float32 draws
              as they are drawn. Each prints the card memory and the
              weights' bytes after load, and (memory_phase) the memory after
              load without the host tier: an unstarted engine with
              kv_offload on and one with it off are built beside the loaded
              one and their allocations measured (they differ in the KV
              pool alone: the default pool cut, 512 -> 384 pages where
              paged).
              Each: one short warm-up request (so no configuration's
              numbers carry the process's first-use costs), then three chat
              requests (one streamed), a seeded sampled chat (temperature
              0.8, max_tokens 64) and one /v1/completions request with a
              ~1500-token prompt, which prefill_chunk splits into
              continued packs, concurrently. max_tokens 32 (the sampled
              chat 64) with ignore_eos: every usage.completion_tokens must
              be its max_tokens. One chat sends
              presence_penalty, frequency_penalty, repeat_penalty and a
              logit_bias of -100 on the first token an engine-level probe
              of its prompt got without them: its 32 tokens (read on the
              engine thread) must not hold that token, and some decode
              steps must run the full sampler variant. Launch counters are
              zeroed just before each configuration's five requests and
              read just after. Every decode burst runs as replays of the
              graph the engine captured at start: the decode kernel's
              launches, counted through the replays, must be 32 x the
              decode steps. Every pack is padded to its bucket (the JAX
              engine's prefill_buckets rule: 32, 128, 512, 1024 here) and
              replays the (bucket, continued) graph the engine captured at
              start: K2 + K2-int8 launches, counted through the replays,
              must be 32 x (the packs + the spec rounds). Speculation is at
              its default (draft "auto" = n-gram self-speculation, n_draft
              4): the greedy requests must take spec rounds (each round a
              decode step, counted among the steps above, and a verify
              pack of K2 / K2-int8), the sampled chat rejection-sampled
              ones (``by_mode["sampled"]``); the penalized chat rides them
              as a plain row. The emitter thread (on by default) must be
              alive and have emitted the requests' tokens. The phases below, up to 3h, measure plain
              bursts: they run with speculation off (draft "0"), on the
              loaded engine and on every engine built from its config;
              3i turns it back on.
  3b. decode  right after each configuration's requests, on the same
              loaded model (decode_phase): 8 requests of 256 greedy tokens
              (ignore_eos, admission held until all 8 are queued, so they
              prefill in one pack and decode in lockstep), once through the
              graph (serving's path, the plain sampler variant), once
              through the full variant's graph on the same neutral slots
              (what a penalized batch costs) and once through the eager
              per-step loop (Engine._burst_eager, which serving never
              selects).
              Each way: decode ms/step as the median over the bursts of 16
              steps with all 8 slots active (at least 10; host wall of the
              burst, waited for: copy in, 16 steps, copy out; the first
              step's logits come from a 1-step probe on the chained state,
              which it then restores), the median host time
              between bursts, a torch.profiler trace of one such burst
              (graph and eager; the full variant is timed only) (CUDA
              kernels per step, the device's busy share of the burst window,
              its idle gaps, the 10 longest kernels by total time),
              the decode kernel's launches = 32 x steps. Greedy streams
              graph vs eager: the agreement is printed, and the first
              step's logits must agree within 2e-2. Capture seconds and
              the graph pool's bytes. A {"decode": ...} JSON line before
              the kernels line holds it all. Each run starts with nothing
              retained for prefix reuse, so both prefill every row.
  3d. prefill right after 3b, on the same loaded model (prefill_phase, on
              the engine's thread): for each of the 8 (bucket, continued)
              pairs a pack of PREFILL_PACKS (fresh: 2-8 segments from row
              0; continued: 2-4 segments over the fresh pack's rows; the
              last segment non-final) through its graph (serving's path)
              and through the eager pack at the same bucket
              (Engine._prefill_eager, which serving never selects): first
              tokens and logits bit for bit, K2 / K2-int8 launched 32 times
              per replay; ms/pack each way (median of 7, host wall: copy
              in, the pack, copy out); a torch.profiler trace of one
              replayed and one eager pack at bucket 512, continued (phase
              3c's turn-2 shape): CUDA kernels, busy share, idle gaps;
              capture seconds and the shared pool's MB. A {"prefill": ...}
              JSON line before the kernels line holds it all.
  3c. prefix  for paged and w8kv8, right after 3d on the same loaded model
              (prefix_phase): device-tier prefix reuse. Engines over the
              same weights, one after the other: kv_prefix_cache on, off,
              on with the pool cut to 96 pages and the host tier off (the
              device tier's eviction path), and (after the traced pair
              below) off with prefill_chunk 256. Each runs turn 1
              (a 1536-token chat prompt = 24 pages = three prefill chunks,
              32 greedy tokens, ignore_eos), then 8 unrelated ~600-token
              requests admitted together (every slot is taken, turn 1's
              too), then turn 2 = turn 1's prompt + its 32 tokens + ~100
              new tokens, then turn 3 = turn 2's first 1620 tokens + 30
              new ones (its slot's own rows end inside a page the prefix
              cache holds: tier 1 and a copy-on-write clone). Asserts: on
              and off give identical greedy tokens for every request (a
              cold turn 2 re-runs exactly the chunks turn 1 ran, so the
              reused rows are the bytes it would compute); turn 2 reuses
              >= 24 x 64 rows (turn 1's committed full pages) through one
              tier-3 hit; off reuses nothing; turn 2's packs are all
              continued and launch K2 (K2-int8 for w8kv8); its decode
              launches the decode kernel 32 x steps through the graph; no
              K2 shape fallback; turn 3 reuses 1620 rows with >= 1 clone
              and launches K2 / K2-int8; the pressure run evicts and
              finishes. Where the chunks differ from the cold run's (turn
              3; the pressure run's shorter surviving chain) bf16
              near-ties may flip tokens, so those are held by their
              first-token logits against the cold run's (relative L2 err
              <= 2e-2; a cold run with prefill_chunk 256 shows what
              chunking alone moves), and the reused pages by their bytes
              on the card: the pages turn 2 reused equal turn 1's (the pressure
              run's against the on run's copy), every COW clone equals
              its source when made, and after turn 3 its clone still
              holds the reused rows and the held source page is unchanged.
              Then on and off once more with turn 2, from submit to its
              first token, under torch.profiler (device busy time and
              share of that window, CUDA kernels, the top kernels; its
              tokens must equal the untraced run's). Prints turn 2's TTFT
              (host clock) and ms/pack on and off, reused rows, COW clones
              and evictions, and a {"prefix_reuse": ...} JSON line before
              the kernels line. Last, the shape witness (the open bf16
              check): on a fresh engine's cache, exact-size eager packs
              (the shapes before the buckets) give the first-token logits
              of turn 3 and of the pressure run's turn 2 three ways: the
              cold run's packs, the packs that wrote the reuse run's rows
              then its last pack, and a cold run whose last pack has the
              reuse run's shape (30 / 388 rows); it prints their pairwise
              errors.
  3g. host    for paged and w8kv8, right after 3c on the same loaded
              model (host_tier_phase): the host tier (kv_offload, on by
              default) on 3c's sequence. (a) pressure at the defaults:
              the 96-page pool with the host tier on; before turn 2 (the
              offload worker drained) the links the wave evicted are in
              the host tier; turn 2 reuses >= 1536 rows, restoring them;
              the pages it reused are byte-equal to the on run's turn 1
              pages and its greedy tokens equal the on run's exactly
              (the same pack shape). (b) evict-all: the pool is the most
              pages the wave's tables held in the on run, so the wave
              evicts every one of turn 1's 24 pages: none is on the card
              before turn 2, all 24 are in the host tier and turn 2
              restores all 24, with the on run's tokens. Turn 2's TTFT
              (host clock) against 3c's off and on runs; in turn 2's
              admission, the host ms in HostPageStore.get (CRC
              included), the restore upload's device ms (CUDA events)
              and host ms, the pages offloaded meanwhile; the offload
              worker's ms per page after its copies landed (CRC,
              insert) and the store's stats(). (c) reload: an
              engine runs turn 1 and the wave with kv_host_store_path
              set (under the git-ignored build/) and saves at shutdown;
              a fresh engine loads the file and serves turn 2 alone:
              it restores all 24 pages, with evict-all's tokens. (d) the
              host-tier race arrangement (race_counts, host tier on; 3f
              runs it with the tier off): on an engine of its own with a
              20-page pool and the emitter on, turn 1 (280 tokens), a
              wave of four each submitted once the one before has its
              first token, turn 2, a second wave, turn 3; the rows turns
              2 and 3 reused are printed (the order of a release and the
              next admission is the card's timing, with the loop's
              top-of-tick drain in place). A {"host_tier": ...} JSON line
              before the kernels line holds it all, with every
              configuration's memory after load.
  3e. shift   for paged and w8kv8, right after 3g on the same loaded
              model (shift_phase): context shift at Llama-3.1-8B width and
              depth. A second engine over the same weights (context 1024,
              chunk 512) serves one greedy request with a 300-token prompt
              and max_tokens 1300 (ignore_eos): it must finish "length"
              after 1300 tokens and shift at least twice, counted from the
              packed_prefill dispatches beyond its first pack; the decode
              kernel launches 32 x steps and K2 32 x packs through the
              graphs. Prints each shift's stall (host clock, from the event
              holding the trigger token to the one holding the next) and a
              {"context_shift": ...} JSON line before the kernels line.
  3f. pipeline for paged and w8kv8, right after 3e on the same loaded
              model (pipeline_phase): the pipelined loop (the defaults:
              pipeline_depth 2, prefill_packed_fuse "auto" = the split
              fused tick) against the synchronous one (pipeline_depth 1,
              "0"), each on an engine of its own over the same weights.
              (a) byte gate: 8 greedy requests queued before the loop
              admits any (prompts of 30-1500 tokens, max_tokens 41-300,
              none a multiple of 16, two stopping on EOS at their first
              token by a +100 logit_bias): tokens identical request by
              request between the two loops, each request ends as it
              must, two bursts were in flight at the defaults, no page in
              use at idle. (b) mixed traffic: 4 long generations decode
              while 4 prompts of 1500 tokens arrive 100 ms apart; every
              completion_tokens == max_tokens, no page in use at idle;
              from the first arrival to the end the card runs under
              torch.profiler (started and stopped on the engine thread):
              the device's busy share, its idle gaps over 20 us (count,
              ms) classed by the work on their two sides (decode->decode:
              between bursts; pack->pack: between a prompt's packs; the
              mixed classes), the arrivals' TTFT (host clock). (c) dedup,
              on the pipelined engine with nothing retained: 4 prompts of
              1500 tokens whose last token differs (the control, first),
              then 4 identical ones; the identical group packs 1500 + 3
              tokens, each sibling reuses 1499 rows, the leader's full
              prompt pages carry >= 2 references after the fork, and each
              sibling's tokens equal the leader's or its first-token
              logits lie within 2e-2 relative L2 of the leader's (the
              count is printed); both groups' TTFT and the packs' device
              ms (CUDA events). (d) 3g (d)'s race arrangement with the
              host tier off. A {"pipeline": ...} JSON line before the
              kernels line holds it all.
  3h. lifecycle for paged and w8kv8, right after 3f on the same loaded
              model (lifecycle_phase): admission control, deadlines, the
              stall watchdog and the priority scheduler, through the HTTP
              server of an engine over the same weights with
              max_queued_requests 4. (a) shed: 8 requests of 400 tokens
              hold the slots, 12 chat requests arrive at once (half
              streamed): exactly 4 queue (then run) and 8 are answered 429
              with Retry-After; submit -> shed event (us) and the 429's
              HTTP time. (b) priority: 8 low requests (600-token prompts,
              300 tokens) decode, then a 1500-token chat arrives with 64
              tokens at low (it waits for a slot: the unpreempted
              reference), high and normal (both outrank low, so each
              preempts a low slot): its TTFT; per victim the pause ->
              resume time, the rows its resume reused (all its committed
              full pages, through the device-tier splice: checked), the
              resume -> next token time, its full 300 tokens (no token
              lost or repeated) and how many equal the unpreempted run's
              (bf16: printed, not a byte gate). (e) deadlines:
              request_timeout_ms 200 with 2000 tokens -> 504 and no page in
              use after; a request queued past max_queue_wait_ms 100 behind
              8 decodes -> 429. (d) stall: dispatch_stall_ms 300 and a GPU
              sleep of ~1 s enqueued on the engine's stream ahead of one
              burst (a hook of this script, stall_once): that request gets
              503, the dispatch -> abort time is printed, and a request
              sent after the sleep has run gets the greedy tokens the
              loaded engine (the same configuration) gives the same
              prompt (a byte gate). (c) pool pressure, on an engine with
              96 pages: 6 low requests (600 + 300) decode, then 2 high
              ones (1500 + 64) arrive; every request completes (with
              preempt off, as before the scheduler, PoolExhausted fails
              them all: tests/test_torch_scheduler.py); preemptions,
              resumes, re-prefills, rows restored at resume and host-tier
              pages restored. A {"lifecycle": ...} JSON line before the
              kernels line holds it all.
  3i. spec    for paged and w8kv8, after 3h, on the same loaded model
              (spec_phase), speculation back at its default. (a) with
              paged only, a small float32 model (head_dim 128) on the
              card: greedy tokens with speculation equal draft "0"'s byte
              for byte on paged, int8 KV and contiguous engines, and the
              captured round equals its eager form
              (DecodeGraph.spec_eager) from the same state: tokens and
              n_out identical, logprobs within 1e-4, with greedy and with
              seeded sampled rows (rejection-sampled acceptance); and 16
              seeded sampled requests x 48 tokens with speculation against
              draft "0": a two-sample chi-square over the token counts, p
              > 0.01 (one law; fixed seeds). (b) 8 greedy requests x
              SPEC_TOKENS (128) tokens admitted together, speculation
              off then on, on two prompt sets: one phrase repeated
              (repetitive) and seeded random ids: decode tok/s (host clock), ms per tick and per
              round or step, acceptance_rate and accept_per_dispatch, the
              share of identical tokens and the first divergence per
              request (bf16: not a byte gate); one spec tick of the
              repetitive run under torch.profiler (CUDA kernels per
              round, busy share, top kernels); then the same with 8
              seeded sampled requests (temperature 0.8): tok/s,
              acceptance, tokens per slot-round. (c) the round's parts
              alone, each captured as a graph of its own and timed with
              CUDA events, 8 slots speculating over 1024 rows: propose,
              the decode step, the verify forward (K2 / K2-int8 and the
              products at M = 40), accept; against the whole round. (d)
              paged only, the emitter thread on against off (emitter_phase,
              speculation off as in 3f, one engine each): phase 3f's byte
              gate requests (tokens identical on and off) with the engine
              thread's host time per busy tick (waits for results
              excluded), and 3f's mixed traffic, untraced: the arrivals'
              TTFT and the decoding requests' mean inter-token time (host
              clock); 3f itself traces that load with the emitter on (the
              default) and reports its device gaps. A {"spec": ...} JSON line before the
              kernels line holds it all, with the serving run's spec
              counters.
  3k. draft   for paged and w8kv8, right after 3i on the same loaded
              model (draft_phase): draft-model speculation. (a) paged
              only, small f32 models on the card (draft_tiny_phase): for
              head_dim 128 and 64, a target with a draft of another shape
              at the defaults, and the target as its own draft with the
              unfused loop (prefill_packed_fuse "0"; the split fused
              tick's plain burst leaves decode_burst rows the draft never
              wrote, as in JAX): greedy tokens with the draft == draft
              "0"'s byte for byte, and the target as its own draft accepts
              >= 90% of its proposals; on the hd-64 pair, 3i (a)'s sampled
              chi-square against draft "0" (p > 0.01). (b) The 1B draft
              (LLAMA32_1B: Llama-3.2-1B's published widths, hd 64, tied
              embeddings) through the runner's loader (draft_config /
              load_draft) from phase 3n's GGUF checkpoint (gguf_1b,
              written at its first use: Q8_0, yarn rope, the config and
              rope scaling from the file), dequantized on the host into
              the target's dtype and quantization; an engine over the loaded
              target with it (draft "auto" -> "model"): its weights' and
              KV's bytes, load and start seconds, capture seconds and pool
              bytes of the decode graphs and of the packs and their draft
              mirrors. Launch counters zeroed, then 3i's 8 x 128 greedy
              runs on both prompt sets with the draft: tok/s, acceptance,
              tokens per slot-round, ms per round and per tick, printed
              beside 3i's n-gram and off runs of the same sets (same call);
              one chat through the HTTP server (48 tokens); counters read:
              the decode kernel launched target layers x steps + draft
              layers x 5 x rounds, K2 / K2-int8 target layers x (packs +
              rounds) + draft layers x mirrored packs. (c) The round's
              parts, each its own graph under CUDA events (round_parts):
              the draft's 5 steps, the decode step, the verify, the
              accept. (d) host tier: a speculating request's chain evicted
              to host RAM and restored: every host entry carries draft
              planes, the restored draft pages equal them byte for byte,
              and the next turn takes spec rounds. A {"draft": ...} JSON
              line before the kernels line holds it all.
  3l. grammar for paged and w8kv8, right after 3k on the same loaded
              model (grammar_phase): grammar-constrained decoding and
              tool calls. It writes its own byte-level tokenizer.json
              under the git-ignored build/ (grammar_vocab: 128,256
              entries, the bytes, the specials at 128000 / 128001 and
              pieces of 2-12 characters from SEED shaped for a JSON
              grammar; nothing is downloaded). (a) paged only, phase 2's
              small f32 model with a 512-entry cut of that vocabulary
              (grammar_tiny_phase): 4 greedy grammar requests (a tool
              call, its arguments, a GBNF list) on an engine whose bursts
              replay the graph and on one running the eager loop, at
              pipeline_depth 1 / prefill_packed_fuse "0" (each burst read
              before the next goes out, so the stale-mask steps do not
              depend on the card's timing): tokens, finishes and
              rollbacks identical, every output in its grammar; then the
              native runtime's rows against the Python automaton's over
              all 128,256 entries at 4 states the call's run visits.
              The vocabulary's cold host costs: token strings, the native
              mask builder, penalty_row at the call's first state and
              inside its free string. (b) an engine over the loaded
              weights with that tokenizer (speculation at its default):
              8 requests x 256 max tokens admitted together, 4 under the
              grammar of a call of the JAX e2e tool (an enum, an integer,
              a free string; logit_bias GRAMMAR_BIAS), 4 free, greedy,
              then sampled (temperature 1, seeded), then the same prompts
              all free: tok/s of the grammar and the free slots, rollbacks
              per grammar token, host ms per grammar token and the memo's
              hits, flushes (rows, per burst, device ms by CUDA events,
              host ms), TTFT grammar vs free, spec ticks; every
              constrained output must be JSON of a call of the schema
              (its enum held) ending "stop". (c) the same engine behind
              the HTTP server: a chat with the tool and a forced
              tool_choice, streamed and not, answered with one
              tool_calls entry of the schema and finish "tool_calls".
              Launch counters zeroed before (b), read after (c): the
              decode kernel 32 x steps, K2 / K2-int8 32 x (packs + spec
              rounds), and K1 + K2 (paged), K3 + K2-int8 + W8 (w8kv8)
              launched. A {"grammar": ...} JSON line before the kernels
              line holds it all; each kernel row's
              "launches_grammar_path" holds 3l's launches by
              configuration, and its "launches" adds those of its own.
  3m. front door (front_door_phase), after every configuration: the
              paged configuration loaded again, through the JAX server's
              front door (``run --models-path``, in process). It writes
              under the git-ignored build/ a models dir: one YAML file
              (parameters with a temperature, top_p and max_tokens; no
              templates, so the llama3 family's are guessed; cutstrings
              "l+" and trimspace " "; the random weights as the option
              random_weights=SEED) and a model dir with Llama-3.1-8B's
              config.json, a tokenizer.json of 128,256 entries with
              merges (the 256 byte characters, 127,744 merges each
              joining two earlier tokens drawn from SEED, Llama-3's split
              regex, the 256 specials at 128000-128255, the BOS
              post-processor; nothing downloaded) and a
              tokenizer_config.json whose chat_template holds
              <|start_header_id|>. Exact checks: the port's encode of 200
              seeded texts equals a naive reference BPE written here
              (fd_reference) and their decode gives them back; the guessed
              templates render the llama3 prompt byte for byte; over HTTP
              /v1/tokenize gives the reference's ids (BOS twice: the
              template's and the encode's, as the JAX server sends them;
              the header specials); a chat forced to " hello" by
              logit_bias comes back raw when streamed and cut / trimmed
              when not, and with "echo" its prompt is the llama3 prompt; a
              stream whose logit_bias pushes <|eot_id|> ends there,
              finish "stop"; a completion and an edit answer; K1 = 32 x
              decode steps and K2 = 32 x (packs + spec rounds) over those
              requests. Printed: host ms to encode phase 3c's two-turn
              chat (llama3-rendered) cold and warm, encode tokens/s, the
              template render ms, and the TTFT of that chat through the
              YAML path beside its rendered text (the same ids) through
              ``run --model`` over the same engine (yaml, model, model,
              yaml; every reusable row forgotten before each), in a
              {"front_door": ...} line before the kernels line; each
              kernel row's "launches_front_door_path" holds 3m's launches
              and its "launches" adds them.
  3n. gguf    after 3m (gguf_phase): GGUF checkpoints, yarn rope and
              LoRA. gguf_1b writes (once; 3k loaded it already) a GGUF v3
              file under the git-ignored build/ with the port's
              write_gguf: Llama-3.2-1B's published widths, random weights
              drawn on the card from seed + 1, every matmul and the tied
              embedding Q8_0, the norms F32, llama.rope.scaling.type yarn
              (factor 4, original context 8192), and 3m's 128,256-entry
              byte-level BPE vocabulary with its merges as
              tokenizer.ggml.* metadata. (a) load_model on the dir holding
              it, paged bf16, 8 slots x 4096: the config (yarn included)
              equals the one it was written for, the tokenizer is the
              file's; every leaf on the card equals the port's numpy
              dequantization (engine/gguf.py) cast to bf16, bit for bit;
              the first-token logits of a 512-token prompt (the pack
              graph's, as 3c reads them) against an engine built from
              those arrays handed over in memory and against an eager
              forward with yarn within 2e-2 relative L2, and farther from
              the eager forward without yarn (the captured graph holds
              yarn's mscale and frequencies). (b) the same file with
              quantization int8: layers 0 and 15 of wq and w_down equal
              quantize_weight of the dequantized leaf; W8 launched. (d) a
              rank-16 PEFT adapter on q_proj / v_proj written here
              (adapter_config.json + a safetensors file; lora_alpha 32)
              merged at load: every merged leaf within one bf16 ulp of W
              + s B@A computed on the card, and the first-token logits
              move beyond 2e-2 relative L2. (c) in each of the three:
              load seconds and the host dequantization share, memory
              after load, the TTFT of 512-token prompts alone (median of
              3) and decode ms/step of 8 slots x 128 greedy tokens
              (speculation off), K1 = 16 x steps and K2 = 16 x packs over
              those requests. A {"gguf": ...} line before the kernels
              line; each kernel row's "launches_gguf_path" holds 3n's
              launches and its "launches" adds them.
  3j. obs     observability at the defaults (trace and kv_audit on). In
              every configuration, right after phase 3's requests (each
              sent with an X-Correlation-ID), the engine idle
              (observability_checks): GET /metrics answers 200 with the
              Prometheus content type, and its packed-prefill, decode
              (bursts, tokens, TTFT count) and speculation counters equal
              metrics(); /debug/trace holds a "request" span and
              /debug/events an "admit" and a "complete" event for each
              correlation id; /debug/kv shows audit checks > 0 and 0
              violations (contig: {"mode": "off"}); no graph was captured
              and no kernel built after start. After every engine's
              shutdown, phases 3-3j, kv_audit_sweep(drained=True) reports 0
              violations and 0 leaked pages. Paged, last (obs_phase): (a)
              the engine's device_mem against torch.cuda.memory_stats(),
              and MFU (non-zero) with its peak; (b) the cost: engines at
              the defaults and at trace=False, kv_audit="off" in turn over
              the loaded weights (speculation off): 3b's decode ms/step
              (the graph), 3f's mixed traffic untraced (TTFT, inter-token
              time) with the tracer's decomp_ms beside the device ms of the
              same packs and bursts by CUDA events; 3f (b) prints the
              tracer's decomp_ms of its traced window beside the
              profiler's busy share; printed, not gated. (c) in 3h (d), the stalled burst's
              span-ring dump loads as Chrome trace JSON and holds the
              stalled request's spans and its burst's dispatch, a flight
              dump names the request, and lifecycle.stall_dumps equals
              its stalls (2 at depth 2: the burst queued behind the
              sleep stalls too, with no request). An
              {"observability": ...} JSON line before the kernels line.
  4. kernels  one JSON line {"kernels": [...]}: for each of the eight kernels,
              launches during its serving configuration (K5 has no serving
              path: its launches are those of phases 2 and 4), parity
              error, kernel / plain / library times at its configuration's
              shapes (median of 20 calls, CUDA events, L2 flushed and a GPU
              sleep before each call, see timed_ms), the bound from bytes
              and operations, and the CUDA kernels one wrapper call runs,
              counted by torch.profiler in this run (a window that
              recorded no kernel of the call is traced again, see
              kernels_per_call; the split-K decode
              kernels enqueue two: split and combine; bf16 W8 / W4 one
              wgmma_kernel, plus a combine where ops/quant.py::tc_plan
              splits K, and nothing else: no library GEMM, no dense
              scratch; their rows carry the plan under "tc_plan" and the
              route under "cuda_route"). K2's row also
              carries, under "fresh", the same numbers on a fresh
              512-token pack (mp = 0), the shape most of its serving
              launches take; K2's and K2-int8's rows carry under
              "verify" the spec round's verify shape (8 segments of 5
              tokens over 1024 committed rows each), its library call
              one batched SDPA over the same rows. W8's and W4's rows
              time w_gate at decode M = 8, and carry lm_head at M = 8 and
              w_gate at M = 512 (the
              wide path) under "lm_head" and "wide", their library call
              the product with a dense bf16 weight of the same shape
              (what the bf16 model runs), and under "per_step" every
              projection shape at M = 8 summed over a decode step.
              The draft path (draft_kernel_rows): under "draft", K1 / K3 /
              K4 at hd 64 over 8 slots x 1024 rows, K2 / K2-int8 at hd 64
              on a 512-token pack over 1024 rows, W8 at the 1B projections
              at M = 8 ("shapes") and the tied int8 table [128256, 2048]
              used transposed ("tied_lm_head": dequantize + matmul), each
              with kernel / plain / library ms and its bound; every row's
              "launches_draft_path" holds 3k's launches by configuration,
              and its "launches" adds those of its own configuration.

The last line of stdout is {"ok": true, "device": {...}}. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
SEED = 1234
HBM_BYTES_PER_S = 3.35e12               # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "max_position_embeddings": 131072,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "tie_word_embeddings": False, "bos_token_id": 128000,
    "eos_token_id": 128001,
}

# the draft model of phase 3k: Llama-3.2-1B at its published widths
# (meta-llama/Llama-3.2-1B's config.json), the public draft for
# Llama-3.1-8B (the same vocabulary and tokenizer family)
LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "max_position_embeddings": 131072,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "tie_word_embeddings": True, "bos_token_id": 128000,
    "eos_token_id": 128001,
}
DRAFT_HD = 64
# the 1B draft's distinct (K, N), and the M its products take: a decode
# step of 8 slots, 5 verify-sized rows a slot, a pack
DRAFT_QUANT_SHAPES = {"wq_wo": (2048, 2048), "wk_wv": (2048, 512),
                      "w_gate_up": (2048, 8192), "w_down": (8192, 2048)}
DRAFT_QUANT_M = (1, 8, 40, 512)

# the serving configurations: (name, load_model knobs, kernels that must
# launch, kernels that must not)
W8, W4 = "quant_matmul_int8", "quant_matmul_int4"
CONFIGS = [
    ("paged", {},
     ("paged_decode_attention", "ragged_prefill_attention"),
     ("paged_decode_attention_quant", "ragged_prefill_attention_int8",
      "decode_attention_append_contig", W8, W4)),
    ("int8", {"kv_cache_dtype": "int8"},
     ("paged_decode_attention_quant", "ragged_prefill_attention_int8",
      "ragged_prefill_attention"),
     ("paged_decode_attention", "decode_attention_append_contig", W8, W4)),
    ("contig", {"kv_layout": "contiguous"},
     ("decode_attention_append_contig", "ragged_prefill_attention"),
     ("paged_decode_attention", "paged_decode_attention_quant",
      "ragged_prefill_attention_int8", W8, W4)),
    ("w8kv8", {"quantization": "int8", "kv_cache_dtype": "int8"},
     (W8, "paged_decode_attention_quant", "ragged_prefill_attention_int8",
      "ragged_prefill_attention"),
     ("paged_decode_attention", "decode_attention_append_contig", W4)),
    ("w4", {"quantization": "int4"},
     (W4, W8, "paged_decode_attention", "ragged_prefill_attention"),
     ("paged_decode_attention_quant", "decode_attention_append_contig")),
]

# the distinct (K, N) of Llama-3.1-8B's projections, and how many of each
# a layer runs (lm_head: once per step)
QUANT_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
                "w_gate_up": (4096, 14336), "w_down": (14336, 4096),
                "lm_head": (4096, 128256)}
PER_LAYER = {"wq_wo": 2, "wk_wv": 2, "w_gate_up": 2, "w_down": 1}
QUANT_M = (1, 8, 16, 17, 512)
# bfloat16 (the tensor-core kernel) adds every token-tile edge (8, 16, 64,
# 128, 256) and the long prompt's third chunk (476 tokens)
QUANT_M_BF16 = (1, 8, 9, 15, 16, 17, 64, 65, 256, 476, 512)


def log(msg: str):
    print(msg, flush=True)


# ---------- phase 1 ----------

def setup():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import localai_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from a checkout of the repo ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from localai_tpu_torch.functions.grammars import native
    from localai_tpu_torch.ops.kernels import build

    t0 = time.monotonic()
    # the native grammar runtime (g++) builds beside the kernels (nvcc)
    gbuild: dict = {}

    def grammar_build():
        try:
            native.get_lib()
            gbuild["s"] = time.monotonic() - t0
        except BaseException as e:        # re-raised below
            gbuild["error"] = e

    gth = threading.Thread(target=grammar_build)
    gth.start()
    built = build.build_all()
    gth.join()
    if "error" in gbuild:
        raise gbuild["error"]
    log(f"[setup] kernels built in {time.monotonic() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})}); "
        f"the native grammar runtime (g++) in {gbuild['s']:.1f} s")
    for name, info in build.BUILD_INFO.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")
    for name in build.SIGNATURES:
        build.library(name)
    # start the profiler's tracing library once on this (the main) thread:
    # the decode phase traces bursts on the engine's thread, and the
    # library initialises its client only on the thread that registered it
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=DEV).add_(1)
        torch.cuda.synchronize()
    return card


# ---------- shared helpers ----------

# GPU sleep before each timed call: ~0.5 ms at the H100's clocks, longer
# than the host takes to queue any call timed here (a plain version queues
# dozens of ops)
SLEEP_CYCLES = 1_000_000


def timed_ms(fn, iters: int = 20) -> float:
    """Median device time of fn() over ``iters`` calls with CUDA events,
    L2 (50 MB) flushed before each call, after a warm-up. A GPU sleep
    (SLEEP_CYCLES) sits between the flush and the start event, so the host
    has queued the whole call (the wrapper's checks included) before the
    start event fires, and the garbage collector is off meanwhile: the
    reading is the call's device time, not the host's. A stall of the
    host that outlasts the sleep can only lengthen a call, so the median
    leaves it out."""
    import statistics

    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        gc.enable()
    return statistics.median(times)


class _Range:
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    """One profiler event: name, device_type, time_range (us)."""
    __slots__ = ("name", "device_type", "time_range")

    def __init__(self, name, device_type, start, end):
        self.name, self.device_type = name, device_type
        self.time_range = _Range(start, end)


def trace_events(prof) -> list:
    """A torch.profiler trace's events (name, device_type, time_range in
    us) read straight from its kineto results: building ``prof.events()``
    (the parent / child tree of every op) takes ~60x longer, tens of
    seconds for a trace of a busy second. ``prof.events()`` where a torch
    has no such results."""
    try:
        return [_Event(e.name(), e.device_type(), e.start_ns() / 1e3,
                       (e.start_ns() + e.duration_ns()) / 1e3)
                for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        return list(prof.events())


# the profiler starts recording device activity 5-18 ms into its window
# (PERF.md §7) and can miss the kernels queued before: a GPU sleep of this
# many cycles (~25 ms at 1.98 GHz) leads each per-call window, and is
# dropped from the count
LEAD_CYCLES = 50_000_000
PROFILE_ATTEMPTS = 5
TRAIL_S = 0.05      # the n-th window stays open n times this long after the call


def kernels_per_call(fn, name=""):
    """The CUDA kernels one call of fn() runs, as torch.profiler (CUPTI)
    records them around that call after a warm-up, behind a GPU sleep
    (LEAD_CYCLES): (count, names), or (None, []) when no window recorded
    a kernel of the call. Late in a long process the profiler drops a
    short window's device records, all of them or only the last (PERF.md
    §7), while the wrapper's launch count shows the call ran: each window
    stays open a while after the call (TRAIL_S), and a window with no
    kernel of the call is traced again, with the lead sleep doubled and
    the wait after the call longer, up to PROFILE_ATTEMPTS windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from localai_tpu_torch.ops.kernels import LAUNCHES

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        n0 = sum(LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_CYCLES << attempt)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRAIL_S * (attempt + 1))
        launched = sum(LAUNCHES.values()) - n0
        dev = [e for e in trace_events(prof) if e.device_type == DeviceType.CUDA]
        names = [e.name for e in dev if not e.name.startswith(("Memcpy", "Memset"))
                 and "spin_kernel" not in e.name]
        if names:
            return len(names), names
        log(f"[kernels] {name}: profiler window {attempt + 1} of {PROFILE_ATTEMPTS} "
            f"recorded no kernel of the call (wrapper launches {launched}; device "
            f"records {[e.name[:32] for e in dev]})")
    return None, []


def max_err(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, got, ref, dtype, mask=None):
    import torch

    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    g, r = got.float(), ref.float()
    if mask is not None:
        g, r = g[mask], r[mask]
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.allclose(g, r, **tol):
        raise AssertionError(f"{name}: kernel != plain, max err "
                             f"{max_err(g, r):.3e} (tol {tol})")
    return max_err(g, r)


KV, G, HD, PG, MP = 8, 4, 128, 64, 64           # 8B heads, 4096 context
C_MAX = PG * MP
S_SLOTS = 8
N_PAGES = S_SLOTS * MP
K5_LAYERS, K5_LAYER = 4, 2


def paged_pool(gen, dtype):
    """A K and V pool: float in ``dtype``, or (dtype "int8") int8 pages with
    float32 scales quantized from unit normals; plus a page permutation."""
    import torch

    from localai_tpu_torch.ops.kvcache import quantize

    shape = (N_PAGES, PG, KV, HD)
    pk = torch.randn(shape, generator=gen, device=DEV)
    pv = torch.randn(shape, generator=gen, device=DEV)
    if dtype == torch.int8:
        (qk, sk), (qv, sv) = quantize(pk), quantize(pv)
        pools = (qk, sk, qv, sv)
    else:
        pools = (pk.to(dtype), pv.to(dtype))
    perm = torch.randperm(N_PAGES, generator=gen, device=DEV).to(torch.int32)
    return pools, perm


def page_table(perm, rows_per_slot):
    """A shuffled page table: slot s owns ceil(rows/PG) pages from perm."""
    import torch

    ptab = torch.full((S_SLOTS, MP), N_PAGES, dtype=torch.int32, device=DEV)
    nxt = 0
    for s, rows in enumerate(rows_per_slot):
        n = -(-int(rows) // PG)
        ptab[s, :n] = perm[nxt:nxt + n]
        nxt += n
    return ptab


def decode_inputs(lengths, dtype, seed, cache_dtype=None):
    """(q, nk, nv, *pools, ptab, lengths) for K1 (float pools) or K3
    (cache_dtype int8: pages_k, scales_k, pages_v, scales_v)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    pools, perm = paged_pool(gen, cache_dtype or dtype)
    ptab = page_table(perm, lengths)
    S = len(lengths)
    q = torch.randn((S, KV * G, HD), generator=gen, device=DEV).to(dtype)
    nk = torch.randn((S, KV, HD), generator=gen, device=DEV).to(dtype)
    nv = torch.randn((S, KV, HD), generator=gen, device=DEV).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return (q, nk, nv, *pools, ptab, lens)


def contig_inputs(lengths, dtype, seed, layers=1):
    """(q, nk, nv, cache_k, cache_v, lengths): caches [layers, S + 1, C, KV,
    hd] (the port's stacked layout with its scratch slot, poisoned: no
    kernel may read it)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    S = len(lengths)
    shape = (layers, S + 1, C_MAX, KV, HD)
    ck = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    cv = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    ck[:, S] = 1e4
    cv[:, S] = -1e4
    q = torch.randn((S, KV * G, HD), generator=gen, device=DEV).to(dtype)
    nk = torch.randn((S, KV, HD), generator=gen, device=DEV).to(dtype)
    nv = torch.randn((S, KV, HD), generator=gen, device=DEV).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return q, nk, nv, ck, cv, lens


def prefill_inputs(N, segs, dtype, seed, cache_dtype=None):
    """segs: [(slot, start, length)] packed in order; the rest of the pack
    is pad tokens, unused table entries pad segments. Returns (args, real):
    args = (q, ck, cv, pages_k, pages_v, ptab, seg_slots, seg_start,
    seg_off, seg_len) and, for cache_dtype int8, kwargs with the scales."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    pools, perm = paged_pool(gen, cache_dtype or dtype)
    rows = [0] * S_SLOTS
    for slot, start, ln in segs:
        rows[slot] = start + ln
    ptab = page_table(perm, rows)
    seg_slots = torch.full((S_SLOTS,), S_SLOTS, dtype=torch.int32)
    seg_start = torch.zeros((S_SLOTS,), dtype=torch.int32)
    seg_off = torch.zeros((S_SLOTS,), dtype=torch.int32)
    seg_len = torch.zeros((S_SLOTS,), dtype=torch.int32)
    real = torch.zeros((N,), dtype=torch.bool)
    off = 0
    for b, (slot, start, ln) in enumerate(segs):
        seg_slots[b], seg_start[b], seg_off[b], seg_len[b] = slot, start, off, ln
        real[off:off + ln] = True
        off += ln
    assert off <= N
    q = torch.randn((N, KV * G, HD), generator=gen, device=DEV).to(dtype)
    ck = torch.randn((N, KV, HD), generator=gen, device=DEV).to(dtype)
    cv = torch.randn((N, KV, HD), generator=gen, device=DEV).to(dtype)
    tabs = [t.to(DEV) for t in (seg_slots, seg_start, seg_off, seg_len)]
    if cache_dtype == torch.int8:
        qk, sk, qv, sv = pools
        return (q, ck, cv, qk, qv, ptab, *tabs), \
            {"scales_k": sk, "scales_v": sv}, real.to(DEV)
    return (q, ck, cv, *pools, ptab, *tabs), {}, real.to(DEV)


@contextlib.contextmanager
def head_dim(hd: int):
    """The phase 2 / 4 input and cost helpers at head_dim ``hd`` (KV 8, G 4
    as the 8B's; 64 is the 1B draft's)."""
    global HD
    saved, HD = HD, hd
    try:
        yield
    finally:
        HD = saved


K2_CASES = {
    128: [(0, 0, 50), (1, 0, 40), (2, 0, 30)],                       # fresh + pads
    512: [(3, 512, 300), (4, 70, 150), (5, 0, 50)],                  # continued, mid-page
    1024: [(6, 1024, 512), (7, 2000, 500)],                          # long continued
}


# ---------- phase 2 ----------

def parity():
    import torch

    from localai_tpu_torch.ops.decode_attention import (
        contig_decode_plain, decode_attention_append_contig,
        decode_attention_append_full, full_decode_plain)
    from localai_tpu_torch.ops.paged_attention import (
        SPLIT_ROWS, paged_decode_attention, paged_decode_attention_quant,
        paged_decode_plain, paged_decode_quant_plain)
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    errs = {}
    # 0, 1, around the decode kernels' split size (64 = the page), long, C - 1
    k1_lengths = [0, 1, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 1000, 2500, C_MAX - 1]

    def record(key, name, got, ref, dname, mask=None):
        e = check_close(name, got, ref, dname, mask=mask)
        errs[key] = max(errs.get(key, 0.0), e)
        log(f"[parity] {name}: max_abs_err {e:.3e}")

    def attention_cases(dname: str, hd: int):
        """Every attention kernel at one dtype and head_dim (the 8B's 128,
        the 1B draft's 64: K5 has no draft path, so 128 only)."""
        dt = getattr(torch, dname)
        args = decode_inputs(k1_lengths, dt, SEED)
        record("paged_decode_attention", f"K1 paged_decode {dname} hd={hd} "
               f"lengths={k1_lengths}", paged_decode_attention(*args, G),
               paged_decode_plain(*args, G), dname)
        args = decode_inputs(k1_lengths, dt, SEED, cache_dtype=torch.int8)
        record("paged_decode_attention_quant", f"K3 int8 paged_decode {dname} "
               f"hd={hd} lengths={k1_lengths}", paged_decode_attention_quant(*args, G),
               paged_decode_quant_plain(*args, G), dname)
        c_lengths = k1_lengths[:-1] + [C_MAX]
        q, nk, nv, ck, cv, lens = contig_inputs(c_lengths, dt, SEED,
                                                layers=K5_LAYERS)
        li = K5_LAYER
        ref = contig_decode_plain(q, nk, nv, ck[li, :S_SLOTS], cv[li, :S_SLOTS],
                                  lens, G)
        record("decode_attention_append_contig", f"K4 contig_decode {dname} "
               f"hd={hd} C={C_MAX} lengths={c_lengths}", decode_attention_append_contig(
                   q, nk, nv, ck[li, :S_SLOTS], cv[li, :S_SLOTS], lens, G),
               ref, dname)
        layer = torch.tensor([li], dtype=torch.int32, device=DEV)
        if hd != DRAFT_HD:
            record("decode_attention_append_full", f"K5 contig_decode_full "
                   f"{dname} L={K5_LAYERS} layer={li}",
                   decode_attention_append_full(q, nk, nv, ck, cv, lens, layer, G),
                   full_decode_plain(q, nk, nv, ck, cv, lens, layer, G), dname)
        del ck, cv
        for N, segs in K2_CASES.items():
            args, _kw, real = prefill_inputs(N, segs, dt, SEED + N)
            record("ragged_prefill_attention", f"K2 ragged_prefill {dname} "
                   f"hd={hd} N={N} segs={segs}", ragged_prefill_attention_paged(*args, G),
                   ragged_prefill_plain(*args, G), dname, mask=real)
            args, kw, real = prefill_inputs(N, segs, dt, SEED + N,
                                            cache_dtype=torch.int8)
            continued = any(start > 0 for _s, start, _n in segs)
            key = ("ragged_prefill_attention_int8" if continued
                   else "ragged_prefill_attention")
            record(key, f"K2{'-int8' if continued else ' (fresh, int8 cache)'} "
                   f"ragged_prefill {dname} hd={hd} N={N} segs={segs}",
                   ragged_prefill_attention_paged(*args, G, **kw,
                                                  continued=continued),
                   ragged_prefill_plain(*args, G, **kw, continued=continued),
                   dname, mask=real)
        torch.cuda.synchronize()
    for hd in (HD, DRAFT_HD):
        with head_dim(hd):
            for dname in ("float32", "bfloat16"):
                attention_cases(dname, hd)
    quant_parity(record)
    for kind in ("paged", "int8", "contig", "w8kv8", "w4"):
        model_parity(kind)
        graph_parity(kind)
        model_parity(kind, draft=True)
        draft_round_parity(kind)
    return errs


def quant_weight(K, N, bits, seed, group=128, tp=1):
    """A {q, s} leaf quantized on the card from normal / sqrt(K) weights
    (the model's init), int8 or int4 (group pick_int4_group(K, group, tp))."""
    import torch

    from localai_tpu_torch.ops.quant import (pick_int4_group, quantize_weight,
                                             quantize_weight_int4)

    gen = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device=DEV).div_(K ** 0.5)
    if bits == 8:
        return quantize_weight(w)
    g = pick_int4_group(K, group, tp)
    return quantize_weight_int4(w, group=g)


def quant_parity(record):
    """W8 / W4 against their plain version (x @ mat(w)) at every 8B
    projection shape, both regimes, float32 and bfloat16 (module doc)."""
    import torch

    from localai_tpu_torch.ops import quant
    from localai_tpu_torch.ops.quant import quant_matmul, quant_matmul_plain

    cases = [(W8, name, K, N, 128, 1, QUANT_M)
             for name, (K, N) in QUANT_SHAPES.items()]
    cases += [(W4, name, K, N, 128, 1, QUANT_M)
              for name, (K, N) in QUANT_SHAPES.items() if name != "lm_head"]
    cases += [(W4, "llama-2 w_down, tp 8", 11008, 4096, 128, 8, (1, 8, 17))]
    # the 1B draft's projections, both weight widths (phase 3k)
    cases += [(key, f"1B {name}", K, N, 128, 1, DRAFT_QUANT_M)
              for key in (W8, W4) for name, (K, N) in DRAFT_QUANT_SHAPES.items()]
    for key, name, K, N, group, tp, ms_f32 in cases:
        leaf = quant_weight(K, N, 8 if key == W8 else 4, SEED + K + N, group, tp)
        g = K // leaf["s"].shape[0] if key == W4 else None
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            ms = (ms_f32 if name.startswith("1B ") or dname == "float32"
                  else QUANT_M_BF16)
            gen = torch.Generator(device=DEV).manual_seed(SEED)
            x_all = torch.randn((max(ms), K), generator=gen, device=DEV).to(dt)
            for M in ms:
                x = x_all[:M]
                record(key, f"{'W8' if key == W8 else 'W4'} {name} {dname} K={K} "
                       f"N={N}{f' g={g}' if g else ''} M={M}",
                       quant_matmul(x, leaf), quant_matmul_plain(x, leaf), dname)
        del leaf
    # the tied int8 tables: the 8B-wide one and the 1B draft's [128256,
    # 2048] (its unembed at each of a round's D + 1 draft steps, M = 8)
    for K, V, m_set in ((QUANT_SHAPES["lm_head"][0], QUANT_SHAPES["lm_head"][1],
                         (1, 8, 512)),
                        (LLAMA32_1B["hidden_size"], LLAMA32_1B["vocab_size"],
                         (1, 8, 40))):
        table = quant_weight(V, K, 8, SEED)               # [V, D], scale along D
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            gen = torch.Generator(device=DEV).manual_seed(SEED)
            for M in m_set:
                x = torch.randn((M, K), generator=gen, device=DEV).to(dt)
                record(W8, f"W8 tied table [{V}, {K}] transposed {dname} M={M}",
                       quant_matmul(x, table, transposed=True),
                       quant_matmul_plain(x, table, transposed=True), dname)
        del table
    torch.cuda.synchronize()
    # the dequantize route's scratch (float32 x, the tied table) is not part
    # of the bf16 serving path: free it, so phase 3's memory reads that path
    quant._SCRATCH.clear()
    torch.cuda.empty_cache()


def small_cfg(draft: bool = False):
    """Phase 2's small float32 llama (hd 128), or its draft of another
    shape at the 1B draft's head_dim (hd 64, one layer, tied embeddings)."""
    import torch

    from localai_tpu_torch.models import llama

    if draft:
        return llama.LlamaConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=384, num_layers=1,
                                 num_heads=4, num_kv_heads=1, head_dim=DRAFT_HD,
                                 rope_theta=500000.0, tie_word_embeddings=True,
                                 dtype=torch.float32)
    return llama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_layers=2, num_heads=4,
                             num_kv_heads=1, head_dim=128, rope_theta=500000.0,
                             dtype=torch.float32)


def model_parity(kind: str, draft: bool = False):
    """A small hd-128 llama (``draft``: its hd-64 draft), float32: kernels
    on the card vs plain versions on the CPU, same weights; prefill (fresh
    then continued) and decode logits within 1e-3 (int8 cache: 5e-3, see
    the module doc)."""
    import torch

    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.kernels import LAUNCHES

    cfg = small_cfg(draft)
    quantize = {"w8kv8": "int8", "w4": "int4"}.get(kind, "")
    int8_kv = kind in ("int8", "w8kv8")
    p_cpu = random_params(cfg, SEED, device="cpu", quantize=quantize)

    def to_dev(v):
        if isinstance(v, dict):
            return {k: to_dev(x) for k, x in v.items()}
        return v.to(DEV)

    p_gpu = to_dev(p_cpu)
    S, C, pg = 4, 256, 64
    out = []
    before = (LAUNCHES[W8], LAUNCHES[W4])
    for dev, params in (("cpu", p_cpu), (DEV, p_gpu)):
        if kind == "contig":
            ck, cv = llama.init_cache(cfg, S, C, 0, device=dev)
        else:
            ck, cv = llama.init_cache(
                cfg, S, C, pg, dtype=torch.int8 if int8_kv else None,
                device=dev)
            ptab = torch.arange(S * C // pg, dtype=torch.int32).flip(0).reshape(S, -1)
            ck["ptab"] = cv["ptab"] = ptab.to(dev)
        gen = torch.Generator().manual_seed(SEED)
        toks = torch.randint(0, 512, (S, 100), generator=gen)
        logs = []
        lengths = torch.zeros(S, dtype=torch.int32)
        for segs in ([(0, 0, 70), (1, 0, 30)], [(0, 70, 20), (2, 0, 40), (1, 30, 5)]):
            N = sum(n for _s, _b, n in segs) + 3
            tokens = torch.zeros(N, dtype=torch.int32)
            positions = torch.full((N,), C, dtype=torch.int32)
            seg_of = torch.full((N,), S, dtype=torch.int32)
            tab = torch.zeros((4, S), dtype=torch.int32)
            tab[0] = S
            off = 0
            for b, (slot, start, n) in enumerate(segs):
                tokens[off:off + n] = toks[slot, start:start + n]
                positions[off:off + n] = torch.arange(start, start + n)
                seg_of[off:off + n] = b
                tab[:, b] = torch.tensor([slot, start, off, n])
                lengths[slot] = start + n
                off += n
            lg = llama.ragged_prefill(
                params, cfg, tokens.to(dev), positions.to(dev),
                *(t.to(dev) for t in tab), seg_of.to(dev), ck, cv,
                continued=any(start > 0 for _s, start, _n in segs))
            logs.append(lg[:len(segs)].cpu())
        for step in range(3):
            lg = llama.decode_step(params, cfg, toks[:, 90 + step].to(dev),
                                   (lengths + step).to(dev), ck, cv)
            logs.append(lg.cpu())
        out.append(logs)
    err = max(max_err(a, b) for a, b in zip(*out))
    tol = 5e-3 if int8_kv else 1e-3
    if not all(bool(torch.isfinite(t).all()) for t in out[1]) or err > tol:
        raise AssertionError(f"model parity ({kind}): card vs CPU logits max "
                             f"err {err:.3e}")
    w8, w4 = LAUNCHES[W8] - before[0], LAUNCHES[W4] - before[1]
    if (w8 > 0) != bool(quantize) or (w4 > 0) != (quantize == "int4"):
        raise AssertionError(f"model parity ({kind}): W8 / W4 launches {w8} / {w4}")
    log(f"[parity] small {'draft ' if draft else ''}model (hd {cfg.head_dim_}, "
        f"f32, {kind}) card kernels vs CPU plain: logits max_abs_err {err:.3e} "
        f"(tol {tol:g}; W8 / W4 launches {w8} / {w4})")


def graph_parity(kind: str):
    """The decode step captured as CUDA graphs (engine/decode_graph.py, the
    plain and the full sampler variant) against the eager per-step loop
    on the card, on model_parity's small hd-128 float32 llama: three slots
    prefilled and one idle, bursts of 16, 8, 1 and 4 steps, every side
    from a twin of the same prefilled state. Three runs:
      plain  greedy, seeded-sampled, greedy slots; graph (plain) vs eager;
      full   the same neutral slots through the full variant's graph:
             equal to the plain graph's run (the full sampler on neutral
             parameters is the plain one);
      feat   slot 0 greedy with repeat / presence / frequency penalties
             and a logit bias of -100 on the token the plain run's slot 0
             chose first, slot 1 seeded typical-p 0.5, slot 2 seeded
             mirostat 2; full graph vs full eager.
    Ids, logprobs, the cache rows and the sampler state (counters, rings,
    mu) must be byte-identical pairwise; the decode kernel's launches,
    counted through the replays, must be layers x steps on every side;
    the banned token never comes out of slot 0."""
    import numpy as np
    import torch

    from localai_tpu_torch.engine import decode_graph, sampling
    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.kernels import LAUNCHES

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=1, head_dim=128, rope_theta=500000.0,
                            dtype=torch.float32)
    quantize = {"w8kv8": "int8", "w4": "int4"}.get(kind, "")
    params = random_params(cfg, SEED, device=DEV, quantize=quantize)
    S, C, pg = 4, 256, 64
    if kind == "contig":
        ck, cv = llama.init_cache(cfg, S, C, 0, device=DEV)
    else:
        ck, cv = llama.init_cache(
            cfg, S, C, pg, dtype=torch.int8 if kind in ("int8", "w8kv8") else None,
            device=DEV)
        ptab = torch.arange(S * C // pg, dtype=torch.int32).flip(0).reshape(S, -1)
        ck["ptab"] = cv["ptab"] = ptab.to(DEV)
    gen = torch.Generator().manual_seed(SEED)
    lengths = np.array([70, 30, 45, 0], np.int32)
    N = int(lengths.sum())
    tokens = torch.randint(0, 512, (N,), generator=gen, dtype=torch.int32)
    positions = torch.cat([torch.arange(n, dtype=torch.int32) for n in lengths[:3]])
    seg_of = torch.cat([torch.full((int(n),), b, dtype=torch.int32)
                        for b, n in enumerate(lengths[:3])])
    tab = torch.tensor([[0, 1, 2, S], [0, 0, 0, 0], [0, 70, 100, 0], [70, 30, 45, 0]],
                       dtype=torch.int32)
    llama.ragged_prefill(params, cfg, tokens.to(DEV), positions.to(DEV),
                         *(t.to(DEV) for t in tab), seg_of.to(DEV), ck, cv,
                         continued=False)
    prompts = torch.split(tokens, [int(n) for n in lengths[:3]])
    H = sampling.SamplingParamsHost

    def sampler(rows):
        sm = sampling.SlotSampler(S, cfg.vocab_size, DEV)
        for s in range(S):
            sm.set_slot(s, rows[s] if s < len(rows) else H(temperature=0.0),
                        fallback_seed=0)
            sm.set_ring(s, prompts[s].tolist() if s < 3 else [])
        return sm

    neutral = [H(temperature=0.0), H(temperature=1.0, top_k=0, top_p=1.0, seed=SEED),
               H(temperature=0.0)]

    def twin(c):
        return {k: (v if k in ("ptab", "itab") else v.clone()) for k, v in c.items()}

    kernel = {"paged": "paged_decode_attention", "int8": "paged_decode_attention_quant",
              "contig": "decode_attention_append_contig",
              "w8kv8": "paged_decode_attention_quant", "w4": "paged_decode_attention"}[kind]
    active = np.array([True, True, True, False])
    steps = (16, 8, 1, 4)
    pristine = (twin(ck), twin(cv))

    def side(rows, full: bool, way: str):
        """One run of the bursts from the prefilled state: (ids and
        logprobs [steps, 2, 3], caches, sampler, graph or None)."""
        k_c, v_c = twin(pristine[0]), twin(pristine[1])
        sm = sampler(rows)
        graph = None
        if way == "graph":
            graph = decode_graph.DecodeGraph(params, cfg, k_c, v_c, sm, S, 16, DEV)
            graph.capture()
        tok, lens = np.array([3, 4, 5, 0], np.int32), lengths.copy()
        n0 = LAUNCHES[kernel]
        res = []
        for n in steps:
            host = (graph.run(tok, lens, active, n, full=full) if graph is not None
                    else decode_graph.eager_burst(params, cfg, k_c, v_c, sm, tok,
                                                  lens, active, n, full=full))
            res.append(host[:, :, :3])
            lens = lens + n * active
            tok = np.where(active, host[-1, 0].astype(np.int64), tok)
        torch.cuda.synchronize()
        launched = LAUNCHES[kernel] - n0
        if launched != cfg.num_layers * sum(steps):
            raise AssertionError(f"graph parity ({kind}, {way}, full={full}): "
                                 f"{kernel} launched {launched} times, expected "
                                 f"{cfg.num_layers * sum(steps)}")
        return np.concatenate(res), (k_c, v_c), sm, graph

    def same(a, b, what):
        (oa, (ka, va), sa, _ga), (ob, (kb, vb), sb, _gb) = a, b
        if not np.array_equal(oa, ob):
            raise AssertionError(f"graph parity ({kind}, {what}): ids / logprobs differ")
        for x, y in ((ka, kb), (va, vb)):
            for k in x:
                if k not in ("ptab", "itab") and not torch.equal(x[k][:, :-1], y[k][:, :-1]):
                    raise AssertionError(f"graph parity ({kind}, {what}): cache {k} differs")
        for name in ("counter", "ring", "ring_pos", "mu"):
            if not torch.equal(getattr(sa, name), getattr(sb, name)):
                raise AssertionError(f"graph parity ({kind}, {what}): sampler {name} differs")

    plain_g = side(neutral, False, "graph")
    same(plain_g, side(neutral, False, "eager"), "plain: graph vs eager")
    same(side(neutral, True, "graph"), plain_g, "neutral full graph vs plain graph")
    banned = int(plain_g[0][0, 0, 0])
    feat = [H(temperature=0.0, repeat_penalty=1.3, presence_penalty=0.5,
              frequency_penalty=0.4, logit_bias={banned: -100.0}),
            H(temperature=1.0, top_k=0, top_p=1.0, typical_p=0.5, seed=SEED),
            H(temperature=1.0, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.3,
              seed=SEED + 1)]
    feat_g = side(feat, True, "graph")
    same(feat_g, side(feat, True, "eager"), "features: graph vs eager")
    if banned in feat_g[0][:, 0, 0].astype(np.int64).tolist():
        raise AssertionError(f"graph parity ({kind}): the banned token {banned} came out")
    mu = feat_g[2].mu.tolist()
    if mu[2] == 6.0 or feat_g[2].counter.tolist()[:3] != [0, sum(steps), sum(steps)]:
        raise AssertionError(f"graph parity ({kind}): mirostat mu {mu} / counters "
                             f"{feat_g[2].counter.tolist()} did not move as expected")
    g = plain_g[3]
    log(f"[parity] small model (hd 128, f32, {kind}) decode graphs vs eager loop: "
        f"{sum(steps)} steps in bursts {steps}; plain (greedy + seeded-sampled) "
        f"graph == eager, the full variant on the same neutral slots == plain, "
        f"and the full variant with penalties + bias / typical-p / mirostat graph "
        f"== eager: ids, logprobs, cache rows, counters, rings and mu "
        f"byte-identical; banned token {banned} never chosen (mu {mu[2]:.4f}); "
        f"{kernel} launches {cfg.num_layers} x {sum(steps)} on every side; capture "
        f"of both variants {g.capture_seconds:.2f} s, pool {g.pool_bytes} bytes")


def draft_round_parity(kind: str):
    """The spec round with a draft model (engine/decode_graph.py: the
    draft's D + 1 steps inside the captured round) against its eager form
    (decode_graph.eager_rounds) on the card, model_parity's small hd-128
    target with its hd-64 draft, both in ``kind``'s weights and cache:
    three slots prefilled into both caches (the draft's on the same page
    table), two speculating (greedy, seeded sampled), one plain, one
    idle; 3 rounds each way from twins of the same state. Ids and n_out
    identical, logprobs within 1e-4, the draft rows written identical;
    the decode kernel launched (target layers + (D + 1) x draft layers) x
    rounds, K2 / K2-int8 target layers x rounds, through the replays."""
    import numpy as np
    import torch

    from localai_tpu_torch.engine import decode_graph, sampling
    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.kernels import LAUNCHES

    cfg, dcfg = small_cfg(), small_cfg(draft=True)
    quantize = {"w8kv8": "int8", "w4": "int4"}.get(kind, "")
    params = random_params(cfg, SEED, device=DEV, quantize=quantize)
    dparams = random_params(dcfg, SEED + 1, device=DEV, quantize=quantize)
    S, C, pg, W = 4, 256, 64, 5
    int8_kv = kind in ("int8", "w8kv8")

    def caches(c):
        if kind == "contig":
            return llama.init_cache(c, S, C, 0, device=DEV)
        k, v = llama.init_cache(c, S, C, pg, dtype=torch.int8 if int8_kv else None,
                                device=DEV)
        k["ptab"] = v["ptab"] = torch.arange(
            S * C // pg, dtype=torch.int32, device=DEV).flip(0).reshape(S, -1)
        return k, v

    gen = torch.Generator().manual_seed(SEED)
    lengths = np.array([70, 30, 45, 0], np.int32)
    N = int(lengths.sum())
    tokens = torch.randint(0, 512, (N,), generator=gen, dtype=torch.int32)
    positions = torch.cat([torch.arange(n, dtype=torch.int32) for n in lengths[:3]])
    seg_of = torch.cat([torch.full((int(n),), b, dtype=torch.int32)
                        for b, n in enumerate(lengths[:3])])
    tab = torch.tensor([[0, 1, 2, S], [0, 0, 0, 0], [0, 70, 100, 0], [70, 30, 45, 0]],
                       dtype=torch.int32)
    state = []
    for p, c in ((params, cfg), (dparams, dcfg)):
        k, v = caches(c)
        llama.ragged_prefill(p, c, tokens.to(DEV), positions.to(DEV),
                             *(t.to(DEV) for t in tab), seg_of.to(DEV), k, v,
                             continued=False)
        state += [k, v]
    prompts = torch.split(tokens, [int(n) for n in lengths[:3]])
    H = sampling.SamplingParamsHost

    def twin(c):
        return {k: (v if k in ("ptab", "itab") else v.clone()) for k, v in c.items()}

    def sampler():
        sm = sampling.SlotSampler(S, cfg.vocab_size, DEV)
        for s, row in enumerate((H(temperature=0.0), H(temperature=0.8, seed=SEED),
                                 H(temperature=0.0), H(temperature=0.0))):
            sm.set_slot(s, row, fallback_seed=0)
            sm.set_ring(s, prompts[s].tolist() if s < 3 else [])
        return sm

    dk = "decode_attention_append_contig" if kind == "contig" else (
        "paged_decode_attention_quant" if int8_kv else "paged_decode_attention")
    k2 = "ragged_prefill_attention_int8" if int8_kv and kind != "contig" \
        else "ragged_prefill_attention"
    host = np.stack([[1, 1, 1, 0], np.ones(S), [3, 4, 5, 0], lengths,
                     [1, 1, 0, 0]]).astype(np.int64)
    out = {}
    for way in ("graph", "eager"):
        k_c, v_c, dk_c, dv_c = (twin(c) for c in state)
        if kind != "contig":
            dk_c["ptab"] = dv_c["ptab"] = k_c["ptab"] = v_c["ptab"]
        sm = sampler()
        draft = (dparams, dcfg, dk_c, dv_c)
        n0 = (LAUNCHES[dk], LAUNCHES[k2])
        if way == "graph":
            g = decode_graph.DecodeGraph(params, cfg, k_c, v_c, sm, S, 16, DEV,
                                         spec_width=W, draft=draft)
            g.capture()
            n0 = (LAUNCHES[dk], LAUNCHES[k2])
            g.load(host)
            res = g.spec_replay(3).wait()
            cap = (g.capture_seconds, g.pool_bytes)
        else:
            res = decode_graph.eager_rounds(
                params, cfg, k_c, v_c, sm, host[2], host[3], host[0] != 0,
                host[4] != 0, 3, W, 3, draft=draft)
        torch.cuda.synchronize()
        out[way] = (res, LAUNCHES[dk] - n0[0], LAUNCHES[k2] - n0[1],
                    {k: x.clone() for k, x in dk_c.items() if k not in ("ptab", "itab")},
                    sm.counter.clone())
    (a, la, ka, da, ca), (b, _lb, _kb, db, cb) = out["graph"], out["eager"]
    if not (np.array_equal(a[:, :W], b[:, :W]) and np.array_equal(a[:, 2 * W], b[:, 2 * W])):
        raise AssertionError(f"draft round parity ({kind}): graph != eager ids "
                             f"{a[:, :W, :3].tolist()} vs {b[:, :W, :3].tolist()}")
    err = float(np.abs(a[:, W:2 * W] - b[:, W:2 * W]).max())
    if err > 1e-4 or not torch.equal(ca, cb):
        raise AssertionError(f"draft round parity ({kind}): logprob err {err:.3e}, "
                             f"counters {ca.tolist()} vs {cb.tolist()}")
    for key in da:
        if not torch.equal(da[key][:, :-1], db[key][:, :-1]):
            raise AssertionError(f"draft round parity ({kind}): draft cache {key} "
                                 f"differs graph vs eager")
    want = 3 * (cfg.num_layers + W * dcfg.num_layers)
    if la != want or ka != 3 * cfg.num_layers:
        raise AssertionError(f"draft round parity ({kind}): {dk} launched {la} "
                             f"(expected {want}), {k2} {ka} (expected "
                             f"{3 * cfg.num_layers}) over 3 rounds")
    log(f"[parity] small model (hd 128, f32, {kind}) with its hd-{DRAFT_HD} draft: "
        f"3 spec rounds, captured == eager (ids, n_out, draft rows, counters; "
        f"logprob err {err:.2e}); {dk} {la} launches = 3 x ({cfg.num_layers} + "
        f"{W} x {dcfg.num_layers}), {k2} {ka}; accepted per round "
        f"{(a[:, 2 * W, :2] - 1).tolist()}; capture {cap[0]:.2f} s, pool "
        f"{cap[1]} bytes")


# ---------- phase 3 ----------

def param_bytes(params) -> int:
    """Bytes of a parameter dict's tensors ({q, s} leaves included)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def http_json(url: str, body=None, timeout=600, cid: str = ""):
    """A request's JSON answer (``cid``: its X-Correlation-ID)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=http_headers(cid))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_headers(cid: str = "") -> dict:
    h = {"Content-Type": "application/json"}
    if cid:
        h["X-Correlation-ID"] = cid
    return h


def http_text(url: str, timeout=120):
    """(status, Content-Type, text) of a GET."""
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def http_stream(url: str, body: dict, timeout=600, cid: str = ""):
    """(chunks, t_first_chunk, t_last_chunk) of an SSE response."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=http_headers(cid))
    chunks, t_first, t_last = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[6:]
            if payload == "[DONE]":
                break
            now = time.monotonic()
            t_first = t_first or now
            t_last = now
            chunks.append(json.loads(payload))
    return chunks, t_first, t_last


def default_chat(messages: list) -> str:
    """The chat prompt that ``run --model`` renders (the default config)."""
    from localai_tpu_torch.api.chatflow import build_chat_prompt
    from localai_tpu_torch.config.model_config import ModelConfig

    return build_chat_prompt(ModelConfig(), messages)[0]


def phase_timed(config: str, fn, *args):
    """fn(*args), its host wall time logged."""
    t = time.monotonic()
    out = fn(*args)
    log(f"[time] {config}: {fn.__name__} {time.monotonic() - t:.1f} s")
    return out


def serve(card: str, config: str, knobs: dict, must: tuple, must_not: tuple):
    """One serving configuration over HTTP (see the module doc); returns
    (launches, shapes)."""
    import torch

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    model_dir = os.path.join(ROOT, "build", "chip_smoke", "llama-3.1-8b")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(LLAMA31_8B, f)
    tag = f"[serve {config}]"
    gb_before = torch.cuda.memory_allocated() / 1e9
    t0 = time.monotonic()
    lm = load_model(model_dir, "llama-3.1-8b", num_slots=S_SLOTS,
                    context_size=C_MAX, dtype="bfloat16", random_weights=SEED,
                    device=DEV, prefill_chunk=512, kv_page_size=PG,
                    decode_burst=16, **knobs)
    torch.cuda.synchronize()
    gb = torch.cuda.memory_allocated() / 1e9
    m = lm.engine.metrics()
    weight_gb = param_bytes(lm.engine.params) / 1e9
    log(f"{tag} Llama-3.1-8B shape, random {lm.quantization or 'bf16'} weights "
        f"(seed {SEED}), 8 slots x 4096 context, KV {m['kv_layout']} "
        f"{m['cache_dtype']}: loaded in {time.monotonic() - t0:.1f} s; weights "
        f"{weight_gb:.3f} GB (10^9 bytes); memory_allocated after load "
        f"{gb:.3f} GB ({gb_before:.3f} GB before the load)")
    memory = memory_phase(lm, card, config, gb)
    app = App({lm.name: lm})
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        ready = http_json(base + "/readyz")
        assert ready["status"] == "ok", ready
        models = http_json(base + "/v1/models")
        assert [m["id"] for m in models["data"]] == [lm.name], models
        long_prompt = ("The quick brown fox jumps over the lazy dog. " * 34)[:1500]
        n_long = len(lm.tokenizer.encode(long_prompt))
        assert n_long > 1024, n_long
        common = {"model": lm.name, "max_tokens": 32, "ignore_eos": True,
                  "temperature": 0}
        chats = [[{"role": "user", "content": f"Question {i}: what is {i} + {i}?"}]
                 for i in range(4)]
        results = {}

        def run(key, fn):
            t = time.monotonic()
            try:
                results[key] = (fn(), t, time.monotonic())
            except Exception as e:      # re-raised on the main thread
                results[key] = (e, t, time.monotonic())

        # chat 2 sends the penalties and bans, by logit_bias -100, the first
        # token its prompt gets without them (an engine-level probe)
        probe = lm.engine.generate(GenRequest(
            prompt_ids=lm.tokenizer.encode(default_chat(chats[2])),
            max_new_tokens=1, params=SamplingParamsHost(temperature=0.0)))
        banned = [ev.token_id for ev in probe][0]
        penalized = {"presence_penalty": 0.5, "frequency_penalty": 0.5,
                     "repeat_penalty": 1.3, "logit_bias": {str(banned): -100}}
        # each request carries an X-Correlation-ID: the engine's spans and
        # events must carry it (observability_checks)
        cids = {k: f"cs-{config}-{k}" for k in ("chat_stream", "chat_1", "chat_2",
                                                 "completion_long", "chat_sampled")}
        jobs = {
            "chat_stream": lambda: http_stream(
                base + "/v1/chat/completions",
                {**common, "messages": chats[0], "stream": True},
                cid=cids["chat_stream"]),
            "chat_1": lambda: http_json(base + "/v1/chat/completions",
                                        {**common, "messages": chats[1]},
                                        cid=cids["chat_1"]),
            "chat_2": lambda: http_json(base + "/v1/chat/completions",
                                        {**common, "messages": chats[2],
                                         **penalized}, cid=cids["chat_2"]),
            "completion_long": lambda: http_json(
                base + "/v1/completions", {**common, "prompt": long_prompt},
                cid=cids["completion_long"]),
            # a seeded sampled chat: speculates with rejection-sampled
            # acceptance (the JAX default). Its own prompt (an identical
            # one would fork) and 64 tokens: the split fused tick's bursts
            # stay plain, and once the prompts are packed every tick is a
            # spec tick
            "chat_sampled": lambda: http_json(
                base + "/v1/chat/completions",
                {**common, "messages": chats[3], "temperature": 0.8,
                 "seed": SEED, "max_tokens": 2 * common["max_tokens"]},
                cid=cids["chat_sampled"]),
        }
        warm = http_json(base + "/v1/completions",
                         {**common, "prompt": "Warm up.", "max_tokens": 4})
        assert warm["usage"]["completion_tokens"] == 4, warm
        m0 = lm.engine.metrics()
        biased = []                       # chat 2's tokens, on the engine thread
        emit = lm.engine._emit

        def spy(slot, token_id, logprob):
            if lm.engine.slots[slot].req.params.logit_bias:
                biased.append(token_id)
            return emit(slot, token_id, logprob)

        lm.engine._emit = spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_start = time.monotonic()
        threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            torch.cuda.synchronize()
        finally:
            del lm.engine._emit
        launches = dict(LAUNCHES)
        wall = time.monotonic() - t_start
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        m1 = lm.engine.metrics()
        for key, (res, _t0, _t1) in results.items():
            if isinstance(res, Exception):
                raise AssertionError(f"{tag} {key} failed: {res!r}")
        if len(results) != len(jobs):
            raise AssertionError(f"{tag} requests did not finish: {sorted(results)}")
        for key in ("chat_1", "chat_2", "completion_long", "chat_sampled"):
            body = results[key][0]
            u = body["usage"]
            want = 64 if key == "chat_sampled" else 32
            assert u["completion_tokens"] == want, (config, key, u)
            assert body["choices"][0]["finish_reason"] == "length", (config, key, body)
        assert results["completion_long"][0]["usage"]["prompt_tokens"] == n_long
        if len(biased) != 32 or banned in biased:
            raise AssertionError(f"{tag} the penalized chat emitted {len(biased)} "
                                 f"tokens, the banned {banned} among them: "
                                 f"{banned in biased}")
        chunks, t_first, t_last = results["chat_stream"][0]
        assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
        final = chunks[-1]
        assert final["usage"]["completion_tokens"] == 32, (config, final)
        assert final["choices"][0]["finish_reason"] == "length", (config, final)
        ttft_ms = (t_first - results["chat_stream"][1]) * 1e3
        decode_tok_s = 31 / max(1e-9, t_last - t_first)
        pk = {k: m1["packed_prefill"][k] - m0["packed_prefill"][k]
              for k in m1["packed_prefill"]}
        dec = {k: m1["decode"][k] - m0["decode"][k] for k in m1["decode"]}
        spec = {k: m1["spec"][k] - m0["spec"][k] for k in SPEC_KEYS}
        spec["by_mode"] = {mode: {k: m1["spec"]["by_mode"][mode][k]
                                  - m0["spec"]["by_mode"][mode][k]
                                  for k in ("rounds", "proposed", "accepted", "tokens")}
                           for mode in ("greedy", "sampled")}
        if spec["rounds"] <= 0 or dec["spec_rounds"] <= 0:
            raise AssertionError(f"{tag} the greedy requests took no spec round "
                                 f"(speculation is on by default): {spec}")
        if spec["by_mode"]["sampled"]["rounds"] <= 0:
            raise AssertionError(f"{tag} the sampled chat took no rejection-sampled "
                                 f"spec round: {spec['by_mode']}")
        emitter = m1["emitter"]
        if not (emitter["enabled"] and emitter["alive"]
                and emitter["emitted"] > m0["emitter"]["emitted"]):
            raise AssertionError(f"{tag} the emitter thread did not emit the "
                                 f"requests' tokens: {emitter}")
        spec["emitted"] = emitter["emitted"] - m0["emitter"]["emitted"]
        if dec["full_steps"] <= 0:
            raise AssertionError(f"{tag} no decode step ran the full sampler "
                                 f"variant for the penalized chat: {dec}")
        step_ms = dec["seconds"] / max(1, dec["steps"]) * 1e3
        pack_ms = pk["seconds"] / max(1, pk["dispatches"]) * 1e3
        log(f"{tag} {card}: 5 concurrent requests in {wall:.2f} s; streamed "
            f"chat TTFT {ttft_ms:.1f} ms, its decode {decode_tok_s:.1f} tok/s "
            f"(31 tokens after the first, HTTP-observed); long completion "
            f"({n_long}-token prompt) e2e "
            f"{(results['completion_long'][2] - results['completion_long'][1]):.2f} s; "
            f"decode {step_ms:.2f} ms per step (host wall, sync included, "
            f"{dec['steps']} steps); packed prefill {pack_ms:.2f} ms per pack "
            f"({pk['dispatches']} packs, {pk['tokens']} tokens); "
            f"{gb:.3f} GB allocated after load, peak {peak_gb:.3f} GB")
        log(f"{tag} packed prefill {json.dumps(pk)}; decode {json.dumps(dec)}; "
            f"speculation {json.dumps(spec)}; kernel launches {json.dumps(launches)}")
        missing = [k for k in must if launches[k] <= 0]
        stray = [k for k in must_not if launches[k] != 0]
        if missing or stray:
            raise AssertionError(f"{tag} kernels not launched on this path: "
                                 f"{missing}; launched off their path: {stray}; "
                                 f"{launches}")
        if pk["continued"] <= 0:
            raise AssertionError(f"{tag} no continued pack (seg_start > 0) ran")
        if pk["kernel_fallback"] != 0:
            raise AssertionError(f"{tag} K2 shape fallbacks: {pk['kernel_fallback']}")
        n_layers = LLAMA31_8B["num_hidden_layers"]
        dk = DECODE_KERNEL[config]
        if launches[dk] != n_layers * dec["steps"]:
            raise AssertionError(f"{tag} {dk} launched {launches[dk]} times over "
                                 f"{dec['steps']} decode steps (graph replays), "
                                 f"expected {n_layers} x {dec['steps']}")
        # every pack and every spec round's verify is a graph replay: K2 /
        # K2-int8 once per layer per pack and per round, counted through
        # the replays (a round's decode step counts among the steps above)
        k2 = launches["ragged_prefill_attention"] + launches["ragged_prefill_attention_int8"]
        if k2 != n_layers * (pk["dispatches"] + dec["spec_rounds"]):
            raise AssertionError(f"{tag} K2 / K2-int8 launched {k2} times over "
                                 f"{pk['dispatches']} packs and {dec['spec_rounds']} "
                                 f"spec rounds (graph replays), expected "
                                 f"{n_layers} per pack and per round")
        obs = phase_timed(config, observability_checks, lm, base, config,
                          list(cids.values()))
        # phase 4's decode shape: the three greedy chats and the long one
        prompt_lens = [len(lm.tokenizer.encode(default_chat(c))) for c in chats[:3]]
        # the phases that measure plain bursts (3b-3h) run with speculation
        # off, on this engine and on every engine built from its config;
        # 3i turns it back on
        pin_speculation(lm.engine, False)
        log(f"[time] {config}: load + serving {time.monotonic() - t0:.1f} s")
        decode = phase_timed(config, decode_phase, lm, card, config)
        prefill = phase_timed(config, prefill_phase, lm, card, config)
        prefix = host = shift = pipeline = lifecycle = spec_out = obs_cost = None
        draft = grammar = None
        if config in PREFIX_K2:
            prefix, runs3c = phase_timed(config, prefix_phase, lm, card, config)
            host = phase_timed(config, host_tier_phase, lm, card, config, runs3c)
            del runs3c
            shift = phase_timed(config, shift_phase, lm, card, config)
            pipeline = phase_timed(config, pipeline_phase, lm, card, config)
            lifecycle = phase_timed(config, lifecycle_phase, lm, card, config)
            pin_speculation(lm.engine, True)
            spec_out = phase_timed(config, spec_phase, lm, card, config)
            draft = phase_timed(config, draft_phase, lm, card, config, spec_out)
            grammar = phase_timed(config, grammar_phase, lm, card, config)
        if config == "paged":
            obs_cost = phase_timed(config, obs_phase, lm, card, config)
        return launches, {"spec": spec_out, "draft": draft, "grammar": grammar,
                          "obs": obs, "obs_cost": obs_cost, "spec_serving": spec,"prompt_lens": prompt_lens, "n_long": n_long,
                          "ttft_ms": ttft_ms, "decode_tok_s": decode_tok_s,
                          "step_ms": step_ms, "pack_ms": pack_ms,
                          "pad_tokens": pk["pad_tokens"],
                          "gb": gb, "peak_gb": peak_gb, "weight_gb": weight_gb,
                          "decode": decode, "prefill": prefill, "prefix": prefix,
                          "shift": shift, "pipeline": pipeline, "host": host,
                          "lifecycle": lifecycle,
                          "memory": memory, "banned": banned}
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
        del lm, app
        gc.collect()
        torch.cuda.empty_cache()


# ---------- phase 3b: decode, graph against eager ----------

DECODE_KERNEL = {"paged": "paged_decode_attention", "int8": "paged_decode_attention_quant",
                 "contig": "decode_attention_append_contig",
                 "w8kv8": "paged_decode_attention_quant", "w4": "paged_decode_attention"}
DECODE_TOKENS = 256          # max_tokens of each of the 8 decode requests
PROFILED_BURST = 3           # which full burst of a run torch.profiler traces
ANNOTATION = "decode_burst"


def trace_split(prof, n_steps: int):
    """From a torch.profiler trace of one burst (inside a record_function
    ANNOTATION range): CUDA kernels per step, the device's busy share of
    the burst's host window (the union of kernel, copy and memset
    intervals over the window), the idle gaps inside that union (count
    and time of those over 20 us, the longest: graph replays queued back
    to back leave none at step boundaries), and the 10 kernels with the
    most total time. None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType

    evs = trace_events(prof)
    win = [e for e in evs if e.name == ANNOTATION and e.device_type == DeviceType.CPU]
    dev = [e for e in evs if e.device_type == DeviceType.CUDA and e.name != ANNOTATION]
    if not win or not dev:
        return None
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1))
                   for e in dev if e.time_range.end > t0 and e.time_range.start < t1)
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append(a - cur_e)
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    long_gaps = [g for g in gaps if g > 20]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    total: dict = {}
    for e in kernels:
        n, t = total.get(e.name, (0, 0.0))
        total[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    top = sorted(total.items(), key=lambda kv: -kv[1][1])[:10]
    return {"kernels_per_step": len(kernels) / n_steps,
            "window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / max(1e-9, t1 - t0),
            "gaps_over_20us": len(long_gaps), "gaps_over_20us_ms": sum(long_gaps) / 1e3,
            "longest_gap_ms": max(gaps, default=0.0) / 1e3,
            "lead_in_ms": (spans[0][0] - t0) / 1e3 if spans else None,
            "top10": [{"kernel": name[:90], "calls": n, "total_ms": t / 1e3}
                      for name, (n, t) in top]}


def forget_retained(eng):
    """Drop the rows an idle engine keeps for prefix reuse (free slots'
    tables and the prefix cache). Engine thread only."""
    if eng._pool is not None:
        eng._reclaim_pages((), eng._pool.num_pages)
    eng._cache_tokens = [[] for _ in eng.slots]


def decode_phase(lm, card: str, config: str, ways=("graph", "full", "eager"),
                 label: str = "") -> dict:
    """8 slots all decoding DECODE_TOKENS tokens (greedy, ignore_eos), once
    through the graph (serving's path) and once through the eager per-step
    loop (``Engine._burst_eager``, which serving never selects), in this
    process on this model. For each: the median ms/step over the bursts of
    16 steps with all 8 slots active (the engine's ``_burst``, host wall:
    copy in, 16 steps, copy out), the median host time between bursts
    (emission and bookkeeping, while the card waits), a torch.profiler
    trace of one such burst (excluded from the median), the decode kernel's launches against 32 x
    steps, and the first step's logits (a 1-step probe before the first
    burst: idempotent, it writes the rows the first step rewrites).
    Phase 3j runs the graph alone (``ways``), tagged ``label``; it then
    returns each way's numbers only."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    eng = lm.engine
    tag = f"[decode {config}{' ' + label if label else ''}]"
    n_layers = LLAMA31_8B["num_hidden_layers"]
    dk = DECODE_KERNEL[config]
    prompts = [lm.tokenizer.encode(f"Decode request {i}: tell a story about "
                                   f"the number {i * 7 + 3}.") for i in range(S_SLOTS)]
    gm = eng.metrics()["decode_graph"]
    if not gm["captured"]:
        raise AssertionError(f"{tag} the engine captured no decode graph")
    runs = {}

    def full_burst(n_steps, active):
        """The full sampler variant's graph on the same (neutral) slots,
        from the loaded (chained) state."""
        return eng._graph.replay(n_steps, full=True)

    for way in ways:
        t_way = time.monotonic()
        fn = {"graph": eng._burst, "full": full_burst,
              "eager": eng._burst_eager}[way]
        rec, probe, prof_box, gaps = [], {}, {}, []

        def timed(n_steps, active, fn=fn, rec=rec, probe=probe, prof_box=prof_box,
                  way=way, gaps=gaps):
            if not probe:                 # the first step's logits, once
                probe["active"] = active.copy()
                g = eng._graph            # the loaded (chained) burst state
                if way != "eager":
                    saved = (g.tokens.clone(), g.lengths.clone())
                    g.replay(1, full=way == "full").wait()
                    probe["logits"] = g.logits.float().clone()
                    g.tokens.copy_(saved[0])
                    g.lengths.copy_(saved[1])
                else:
                    probe["logits"] = llama.decode_step(
                        eng.params, eng.cfg, g.tokens, g.lengths, eng.ck, eng.cv,
                        active=g.active).float()
                probe["steps"] = 1
            full = n_steps == 16 and int(active.sum()) == S_SLOTS
            # the full variant is timed, not traced (its kernels are the
            # plain step's plus the sampler's, PR 12)
            traced = (full and way != "full" and not prof_box
                      and sum(r[3] for r in rec) == PROFILED_BURST)
            t = time.perf_counter()
            if rec:                       # host time since the last burst ended
                gaps.append(t - rec[-1][4])
            if traced:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with record_function(ANNOTATION):
                        host = fn(n_steps, active)
                        host.wait()
                prof_box["prof"], prof_box["steps"] = prof, n_steps
            else:
                host = fn(n_steps, active)
                host.wait()
            end = time.perf_counter()
            rec.append((n_steps, int(active.sum()), end - t, full and not traced, end))
            return host

        # admission waits until all 8 requests are queued, so both runs
        # prefill them in one pack and decode in lockstep; both start with
        # nothing retained for prefix reuse, so both prefill every row
        gate = threading.Event()
        admit = eng._admit
        fresh = [True]

        def gated(admit=admit, gate=gate, fresh=fresh):
            if not gate.is_set():
                return False
            if fresh:
                fresh.clear()
                forget_retained(eng)
            return admit()

        eng._admit = gated
        eng._burst = timed
        try:
            m0 = eng.metrics()["decode"]
            torch.cuda.synchronize()
            reset_launches()
            outs = [eng.submit(GenRequest(
                prompt_ids=list(p), max_new_tokens=DECODE_TOKENS, ignore_eos=True,
                params=SamplingParamsHost(temperature=0.0))) for p in prompts]
            gate.set()
            eng._wake.set()
            streams = []
            for o in outs:
                ids = []
                while True:
                    ev = o.get(timeout=900)
                    if ev is None:
                        break
                    if ev.error:
                        raise AssertionError(f"{tag} {way}: {ev.error}")
                    ids.extend(ev.token_ids or [ev.token_id])
                streams.append(ids)
            torch.cuda.synchronize()
            launched = dict(LAUNCHES)
            m1 = eng.metrics()["decode"]
        finally:
            del eng._burst, eng._admit    # back to the class's methods
        steps = m1["steps"] - m0["steps"]
        if any(len(ids) != DECODE_TOKENS for ids in streams):
            raise AssertionError(f"{tag} {way}: stream lengths "
                                 f"{[len(i) for i in streams]}")
        if launched[dk] != n_layers * (steps + probe["steps"]):
            raise AssertionError(f"{tag} {way}: {dk} launched {launched[dk]} times "
                                 f"for {steps} + {probe['steps']} (probe) steps, "
                                 f"expected {n_layers} per step")
        per_step = [sec / n * 1e3 for n, _a, sec, use, _e in rec if use]
        if len(per_step) < 10:
            raise AssertionError(f"{tag} {way}: only {len(per_step)} bursts of 16 "
                                 f"steps with all {S_SLOTS} slots active: {rec}")
        t_split = time.monotonic()
        split = trace_split(prof_box["prof"], prof_box["steps"]) if prof_box else None
        log(f"[time] {config}: decode_phase {way}: run {t_split - t_way:.1f} s, "
            f"trace {time.monotonic() - t_split:.1f} s")
        runs[way] = {"ms_per_step": statistics.median(per_step),
                     "ms_per_step_min": min(per_step), "ms_per_step_max": max(per_step),
                     "bursts": len(per_step), "steps": steps,
                     "between_bursts_ms": statistics.median(gaps) * 1e3,
                     "launches": launched[dk], "trace": split,
                     "streams": streams, "logits": probe["logits"],
                     "active": probe["active"]}
        tr = split or {}
        log(f"{tag} {card}: {way}: decode {runs[way]['ms_per_step']:.3f} ms/step "
            f"(median of {len(per_step)} bursts of 16 steps, 8 slots; min "
            f"{min(per_step):.3f}, max {max(per_step):.3f}; host time between "
            f"bursts, median {runs[way]['between_bursts_ms']:.3f} ms); {dk} "
            f"launches {launched[dk]} = {n_layers} x ({steps} + 1 probe) steps; "
            + (f"trace of one burst: {tr['kernels_per_step']:.1f} CUDA kernels per "
               f"step, device busy {tr['busy_share'] * 100:.1f}% of the "
               f"{tr['window_ms']:.2f} ms window ({tr['lead_in_ms']:.3f} ms before "
               f"the first device activity; {tr['gaps_over_20us']} idle gaps over "
               f"20 us, {tr['gaps_over_20us_ms']:.3f} ms in all, longest "
               f"{tr['longest_gap_ms']:.3f} ms)" if split else
               ("not traced" if way == "full" else
                "trace: the profiler recorded no device activity (not measured)")))
        if split:
            log(f"{tag} {way}: 10 longest kernels by total time in the traced "
                f"burst: {json.dumps(split['top10'])}")
    if tuple(ways) != ("graph", "full", "eager"):
        return {way: {k: v for k, v in r.items()
                      if k not in ("streams", "logits", "active")}
                for way, r in runs.items()}
    g, e, f = runs["graph"], runs["eager"], runs["full"]
    full_same = sum(a == b for a, b in zip(g["streams"], f["streams"]))
    log(f"{tag} full sampler variant vs plain (neutral greedy slots): "
        f"{f['ms_per_step']:.3f} vs {g['ms_per_step']:.3f} ms/step "
        f"({(f['ms_per_step'] / g['ms_per_step'] - 1) * 100:+.1f}%); "
        f"{full_same} of {S_SLOTS} streams identical; first step's logits "
        f"max abs err {max_err(f['logits'], g['logits']):.3e}")
    same = sum(a == b for a, b in zip(g["streams"], e["streams"]))
    agree = sum(x == y for a, b in zip(g["streams"], e["streams"])
                for x, y in zip(a, b)) / (S_SLOTS * DECODE_TOKENS)
    if not (g["active"].all() and e["active"].all() and f["active"].all()):
        raise AssertionError(f"{tag} the first burst did not decode all "
                             f"{S_SLOTS} slots: {g['active']} / {e['active']}")
    first = max_err(g["logits"], e["logits"])
    if first > 2e-2:
        raise AssertionError(f"{tag} first decode step's logits: graph vs eager "
                             f"max err {first:.3e} > 2e-2")
    log(f"{tag} graph vs eager greedy tokens: {same} of {S_SLOTS} streams "
        f"identical, {agree * 100:.2f}% of tokens agree; first step's logits max "
        f"abs err {first:.3e} (tol 2e-2); capture {gm['capture_seconds']:.2f} s, "
        f"graph pool {gm['pool_bytes']} bytes")
    out = {"capture_s": gm["capture_seconds"], "pool_bytes": gm["pool_bytes"],
           "streams_identical": same, "token_agreement": agree,
           "full_streams_identical": full_same,
           "first_step_logits_err": first}
    for way, r in runs.items():
        out[way] = {k: v for k, v in r.items()
                    if k not in ("streams", "logits", "active")}
    return out


# ---------- phase 3d: prefill, graph against eager ----------

# per pack bucket, the segments of a fresh pack and of a continued pack
# over its rows: (slot, tokens) each, the last segment non-final; totals
# fall in (previous bucket, bucket], so the engine's rule picks the bucket
PREFILL_PACKS = {
    32: ([(0, 20), (1, 10)], [(0, 16), (1, 12)]),
    128: ([(0, 50), (1, 40), (2, 20), (3, 10)], [(0, 60), (1, 40), (2, 20)]),
    512: ([(0, 200), (1, 100), (2, 80), (3, 50), (4, 30), (5, 20), (6, 20), (7, 10)],
          [(0, 200), (1, 150), (2, 100), (3, 50)]),
    1024: ([(0, 512), (1, 500)], [(0, 512), (1, 500)]),
}
PREFILL_REPS = 7             # timed packs per (bucket, continued) and way
TRACED_PACK = (512, True)    # the bucket of phase 3c's continued turn-2 pack


def on_engine_thread(eng, fn, timeout=900):
    """Run fn() on an idle engine's thread (the thread that owns its CUDA
    state and replays its graphs), at its next tick; return its result."""
    box, done = {}, threading.Event()
    admit = eng._admit

    def hook(admit=admit):
        if not done.is_set():
            try:
                box["result"] = fn()
            except BaseException as e:     # re-raised on the caller's thread
                box["error"] = e
            finally:
                done.set()
        return admit()

    eng._admit = hook
    try:
        eng._wake.set()
        if not done.wait(timeout):
            raise AssertionError("the engine thread did not run the phase")
    finally:
        del eng._admit
    if "error" in box:
        raise box["error"]
    return box["result"]


def prefill_phase(lm, card: str, config: str) -> dict:
    """Phase 3d on the loaded model (module doc): every (bucket, continued)
    pack of PREFILL_PACKS through its captured graph (serving's path) and
    through the eager pack at the same bucket (``Engine._prefill_eager``,
    which serving never selects): first tokens and logits bit for bit,
    ms/pack each way (median of PREFILL_REPS, host wall: copy in, the
    pack, copy out), a torch.profiler trace of one replayed pack
    (TRACED_PACK) and of the eager one, capture seconds and pool MB. Runs
    on the engine's thread; greedy slots, nothing retained before or
    after."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from localai_tpu_torch.engine.prefill_graph import n_finals, new_pack, split_pack
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    eng = lm.engine
    tag = f"[prefill {config}]"
    n_layers = LLAMA31_8B["num_hidden_layers"]
    pm = eng.metrics()["prefill_graph"]
    want = [(b, c) for b in eng._pack_buckets for c in (False, True)]
    if pm["captured"] != want or sorted(PREFILL_PACKS) != list(eng._pack_buckets):
        raise AssertionError(f"{tag} captured {pm['captured']}, expected {want} "
                             f"(phase packs for {sorted(PREFILL_PACKS)})")
    gen = np.random.default_rng(SEED)
    vocab = LLAMA31_8B["vocab_size"]

    def pack(bucket, segs, starts):
        host = new_pack(bucket, S_SLOTS, C_MAX)
        v = split_pack(host, bucket, S_SLOTS)
        off = 0
        for b, (slot, n) in enumerate(segs):
            start = starts.get(slot, 0)
            v["tokens"][off:off + n] = gen.integers(0, vocab, n)
            v["positions"][off:off + n] = np.arange(start, start + n)
            v["seg_of"][off:off + n] = b
            v["seg_slots"][b], v["seg_start"][b] = slot, start
            v["seg_off"][b], v["seg_len"][b] = off, n
            v["final_mask"][b] = b < len(segs) - 1
            off += n
        assert off <= bucket
        return host

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    def body():
        forget_retained(eng)
        for slot in range(S_SLOTS):
            eng.sampler.set_slot(slot, SamplingParamsHost(temperature=0.0), 0)
            if eng._pool is not None:
                eng._pool.ensure(slot, 1024)
        eng._commit_ptab()
        counters = eng.sampler.counter.clone()
        rows, traces = {}, {}
        for bucket, (fresh, cont) in PREFILL_PACKS.items():
            starts = {}
            for continued, segs in ((False, fresh), (True, cont)):
                host = pack(bucket, segs, starts)
                reset_launches()
                g_out = eng._prefill_pack(bucket, continued, host).wait()[
                    :, :n_finals(host, bucket, S_SLOTS)]
                g_logits = eng._pgraph.logits[:len(segs)].float().clone()
                torch.cuda.synchronize()
                g_launch = dict(LAUNCHES)
                e_out, e_logits = eng._prefill_eager(bucket, continued, host)
                e_logits = e_logits[:len(segs)].float()
                same = (np.array_equal(g_out, e_out)
                        and bool(torch.equal(g_logits, e_logits)))
                k2 = g_launch["ragged_prefill_attention"] + \
                    g_launch["ragged_prefill_attention_int8"]
                if not same or k2 != n_layers:
                    raise AssertionError(
                        f"{tag} bucket {bucket} continued={continued}: graph vs "
                        f"eager ids {g_out[0].tolist()} / {e_out[0].tolist()}, "
                        f"logits max err {max_err(g_logits, e_logits):.3e}; "
                        f"K2 launches in the replay {k2} (expected {n_layers})")
                # both write the same rows from the same inputs, so the
                # repeats are idempotent
                g_ms = [timed(lambda: eng._prefill_pack(bucket, continued,
                                                        host).wait())
                        for _ in range(PREFILL_REPS)]
                e_ms = [timed(lambda: eng._prefill_eager(bucket, continued, host))
                        for _ in range(PREFILL_REPS)]
                if (bucket, continued) == TRACED_PACK:
                    for way, fn in (("graph", lambda: eng._prefill_pack(
                            bucket, continued, host).wait()),
                                    ("eager", lambda: eng._prefill_eager(
                                        bucket, continued, host))):
                        torch.cuda.synchronize()
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
                            with record_function(ANNOTATION):
                                fn()
                        traces[way] = trace_split(prof, 1)
                tokens = sum(n for _s, n in segs)
                rows[f"{bucket}{'c' if continued else 'f'}"] = {
                    "bucket": bucket, "continued": continued, "tokens": tokens,
                    "segments": len(segs), "graph_ms": statistics.median(g_ms),
                    "graph_ms_min": min(g_ms), "eager_ms": statistics.median(e_ms),
                    "eager_ms_min": min(e_ms), "launches": {
                        k: n for k, n in g_launch.items() if n}}
                starts = {slot: n for slot, n in segs}
        if not torch.equal(counters, eng.sampler.counter):
            raise AssertionError(f"{tag} greedy packs moved the sampler counters")
        for slot in range(S_SLOTS):
            if eng._pool is not None:
                eng._pool.release(slot, 0)
        eng._commit_ptab()
        return rows, traces

    rows, traces = on_engine_thread(eng, body)
    for key, r in rows.items():
        log(f"{tag} {card}: bucket {r['bucket']} {'continued' if r['continued'] else 'fresh'} "
            f"({r['tokens']} tokens, {r['segments']} segments): graph == eager "
            f"bit for bit (first tokens, logits); {r['graph_ms']:.3f} ms/pack "
            f"graph (min {r['graph_ms_min']:.3f}) vs {r['eager_ms']:.3f} eager (min "
            f"{r['eager_ms_min']:.3f}), host wall, median of {PREFILL_REPS}; "
            f"launches per replay {json.dumps(r['launches'])}")
    for way, tr in traces.items():
        log(f"{tag} {card}: trace of one {way} pack at bucket {TRACED_PACK[0]} "
            f"continued: "
            + (f"{tr['kernels_per_step']:.0f} CUDA kernels, device busy "
               f"{tr['device_busy_ms']:.3f} ms = {tr['busy_share'] * 100:.1f}% of the "
               f"{tr['window_ms']:.3f} ms window ({tr['lead_in_ms']:.3f} ms before the "
               f"first device activity; {tr['gaps_over_20us']} idle gaps over 20 us, "
               f"{tr['gaps_over_20us_ms']:.3f} ms in all, longest "
               f"{tr['longest_gap_ms']:.3f} ms); top kernels "
               f"{json.dumps(tr['top10'][:5])}" if tr else
               "the profiler recorded no device activity (not measured)"))
    log(f"{tag} {card}: {len(pm['captured'])} graphs captured in "
        f"{pm['capture_seconds']:.2f} s (warm-ups included), shared pool "
        f"{pm['pool_bytes'] / 1e6:.1f} MB")
    return {"capture_s": pm["capture_seconds"], "pool_bytes": pm["pool_bytes"],
            "packs": rows, "trace": traces}


# ---------- phase 3c: prefix reuse ----------

# the continued-prefill kernel of each configuration the phase runs
PREFIX_K2 = {"paged": "ragged_prefill_attention",
             "w8kv8": "ragged_prefill_attention_int8"}
TURN1_TOKENS = 1536   # 24 pages of 64: the three prefill chunks a cold turn 2 re-runs
TURN_NEW = 32         # greedy tokens of each turn
TURN2_EXTRA = 100     # new prompt tokens of turn 2
UNRELATED, UNRELATED_TOKENS, UNRELATED_NEW = 8, 600, 16
# turn 3 = turn 2's first 1620 tokens + 30 new: its slot's own rows (tier 1)
# end inside page 25, which the prefix cache holds, so that page is cloned
TURN3_REUSE, TURN3_EXTRA = 1620, 30
# pages of the pressure run's pool: the unrelated wave alone needs 8 x 10,
# so turn 1's retained chain (24 pages) must be evicted, at least in part
PRESSURE_PAGES = 96
# turn 3 and the pressure run's turn 2 prefill other chunks than a cold
# run, so bf16 rounding moves their logits: they are held to a relative
# L2 error (||a - b|| / ||b|| over the vocabulary) against the cold run's
PREFIX_LOGITS_RTOL = 2e-2
RECHUNK = 256         # prefill_chunk of the cold run with other chunks


def chain_pages(eng, ids) -> list:
    """The physical pages of ids' chain in the engine's prefix cache, root
    first, as far as it is indexed (read only: no LRU touch)."""
    pages = []
    for key in eng._pcache.chain_keys(ids):
        e = eng._pcache._entries.get(key)
        if e is None:
            break
        pages.append(e.page)
    return pages


def page_bytes(eng, pages) -> list:
    """Copies of the K and V pages (and int8 scales) of physical
    ``pages``, every layer: [L, len(pages), PG, ...] each."""
    import torch

    idx = torch.tensor(pages, dtype=torch.long, device=DEV)
    leaves = [eng.ck["pages"], eng.cv["pages"]]
    if "scales" in eng.ck:
        leaves += [eng.ck["scales"], eng.cv["scales"]]
    return [t.index_select(1, idx) for t in leaves]


def prefix_sequence(lm, eng, tag: str, config: str, trace: bool = False,
                    turn1_ref=None, before_turn2=None, after_turn2=None,
                    upto: str = "turn3") -> dict:
    """Turn 1, 8 unrelated requests admitted together (every slot, turn 1's
    too), turn 2 = turn 1's prompt + its output + TURN2_EXTRA tokens, on
    ``eng`` (requests built by the runner, submitted to the engine, each
    event awaited at most 300 s), then turn 3 (TURN3_REUSE). Launch
    counters are zeroed just before turn 2 and read just after, and again
    for turn 3. ``trace``: turn 2's packs, up
    to the one that samples its first token, run under torch.profiler on
    the engine thread, as phase 3b traces a burst (trace_split of that
    window). Turns 2 and 3 keep their first token's logits. With reuse on:
    turn 1's retained pages are copied after turn 1 ("turn1_pages"), the
    pages turn 2 reused are compared after turn 2 with ``turn1_ref`` (an
    earlier run's copy; this run's own by default), and every copy-on-write
    clone is compared with its source on the engine thread as it is made,
    the source kept for the checks after turn 3. The most pages the
    running requests' tables held during the wave is "wave_peak_pages".
    ``before_turn2`` / ``after_turn2`` (callables) run just before turn 2
    is submitted and just after it ended; ``upto="wave"`` stops after the
    wave (turn 1's prompt and tokens)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from localai_tpu_torch.backend import runner
    from localai_tpu_torch.engine.prefill_graph import n_finals
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tok = lm.tokenizer
    greedy = {"ignore_eos": True, "temperature": 0}
    head = "Turn one of a chat about paged attention on one card. "
    user1 = (head * (TURN1_TOKENS // len(head) + 1))[:TURN1_TOKENS - len("user: ")]
    p1 = tok.encode(default_chat([{"role": "user", "content": user1}]))
    assert len(p1) == TURN1_TOKENS, len(p1)

    def run(req):
        t0, t_first, ids, last = time.monotonic(), None, [], None
        out = eng.submit(req)
        while (ev := out.get(timeout=300)) is not None:
            if ev.error:
                raise AssertionError(f"{tag}: {ev.error}")
            t_first = t_first or time.monotonic()
            ids.extend(ev.token_ids or [ev.token_id])
            last = ev
        return ids, (t_first - t0) * 1e3, last

    def request(ids, n):
        req = runner.build_request(lm, "", {**greedy, "max_tokens": n})
        req.prompt_ids = list(ids)
        return req

    firsts: dict = {}        # first-token logits of turns 2 and 3
    box: dict = {}           # turn 2's traced window (``trace``)
    run_pack = eng._prefill_pack

    def pack_probe(bucket, continued, host, run_pack=run_pack):
        out = run_pack(bucket, continued, host)
        finals = n_finals(host, bucket, S_SLOTS)
        key = firsts.pop("next", None) if finals else None
        if key:                # the first pack that samples a first token
            firsts[key] = eng._pgraph.logits[0].float().clone()
        if finals and "open" in box and "prof" not in box:
            # the traced window ends when this pack's first tokens land,
            # before a fused tick's burst is dispatched behind it
            out.wait()
            box["open"][1].__exit__(None, None, None)
            torch.cuda.synchronize()
            box["open"][0].__exit__(None, None, None)
            box["prof"] = box["open"][0]
        return out

    eng._prefill_pack = pack_probe
    clones = []              # (src, dst, src bytes at the clone, dst == src)
    if eng._pcache is not None:
        def clone_probe(src, dst, clone=eng._clone_page):
            clone(src, dst)
            before = page_bytes(eng, [src])
            clones.append((src, dst, before, all(
                torch.equal(a, b) for a, b in zip(before, page_bytes(eng, [dst])))))

        eng._clone_page = clone_probe
    turn1, _ttft1, _ev = run(request(p1, TURN_NEW))
    turn1_pages = (page_bytes(eng, chain_pages(eng, p1))
                   if eng._pcache is not None else None)
    # the unrelated wave: admission held until all are queued, so they take
    # the 8 slots at once
    gate = threading.Event()
    admit = eng._admit
    eng._admit = lambda admit=admit, gate=gate: gate.is_set() and admit()
    peak = [0]
    ensure = eng._ensure_pages

    def ensure_probe(slot, rows, ensure=ensure):
        ensure(slot, rows)
        peak[0] = max(peak[0], sum(int(eng._pool.owned[i])
                                   for i, sl in enumerate(eng.slots) if sl is not None))

    eng._ensure_pages = ensure_probe
    try:
        outs = []
        for i in range(UNRELATED):
            text = f"Request {i}: " + f"an unrelated question number {i * 37 + 11}. " * 20
            ids = tok.encode(default_chat([{"role": "user",
                                           "content": text[:UNRELATED_TOKENS - 6]}]))
            outs.append(eng.submit(request(ids, UNRELATED_NEW)))
        t_end = time.monotonic() + 60
        while eng._queue.qsize() < UNRELATED and time.monotonic() < t_end:
            time.sleep(0.001)
        gate.set()
        eng._wake.set()
        unrelated = []
        for o in outs:
            ids = []
            while (ev := o.get(timeout=300)) is not None:
                if ev.error:
                    raise AssertionError(f"{tag} unrelated request: {ev.error}")
                ids.extend(ev.token_ids or [ev.token_id])
            unrelated.append(ids)
    finally:
        del eng._admit
        del eng._ensure_pages
    if upto == "wave":
        del eng._prefill_pack
        if eng._pcache is not None:
            del eng._clone_page
        return {"p1": p1, "turn1": turn1, "unrelated": unrelated,
                "wave_peak_pages": peak[0]}
    p2 = p1 + turn1 + tok.encode("\nuser: " + ("And what about turn two? " * 5)[:TURN2_EXTRA - 7])
    if before_turn2 is not None:
        before_turn2()
    m0 = eng.metrics()
    torch.cuda.synchronize()
    reset_launches()
    if trace:
        prefill = eng._dispatch_prefill

        def traced(prefill=prefill, box=box):
            if "prof" in box or not eng._prefill_queue:
                return prefill()
            if "open" not in box:
                box["open"] = (profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]),
                               record_function(ANNOTATION))
                for ctx in box["open"]:
                    ctx.__enter__()
            return prefill()      # pack_probe closes the window

        eng._dispatch_prefill = traced
    firsts["next"] = "turn2"
    try:
        turn2, ttft2, last = run(request(p2, TURN_NEW))
    finally:
        if trace:
            del eng._dispatch_prefill
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    m1 = eng.metrics()
    if after_turn2 is not None:
        after_turn2()
    spliced = None           # (pages turn 2 reused, their bytes == turn 1's)
    if eng._pcache is not None:
        ref = turn1_ref if turn1_ref is not None else turn1_pages
        n = last.timings["reused_prompt_tokens"] // PG
        got = page_bytes(eng, chain_pages(eng, p2)[:n])
        spliced = (n, len(got[0][0]) == n and all(
            torch.equal(a, b[:, :n]) for a, b in zip(got, ref)))
    p3 = p2[:TURN3_REUSE] + tok.encode((" A third turn, shorter." * 3)[:TURN3_EXTRA])
    reset_launches()
    n_clones = len(clones)
    firsts["next"] = "turn3"
    turn3, _ttft3, last3 = run(request(p3, TURN_NEW))
    torch.cuda.synchronize()
    launches3 = dict(LAUNCHES)
    evicted3 = (eng.metrics().get("prefix_cache", {}).get("evicted_pages", 0)
                - m1.get("prefix_cache", {}).get("evicted_pages", 0))
    # turn 3's clones: the clone equalled its source when made; after turn 3
    # the rows before its first write still do, and the source (a page the
    # prefix cache holds) was not written (unless evicted since)
    r3 = TURN3_REUSE % PG
    clone_checks = []
    for src, dst, before, same in clones[n_clones:]:
        now_dst = page_bytes(eng, [dst])
        kept = all(torch.equal(a[:, :, :r3], b[:, :, :r3])
                   for a, b in zip(now_dst, before))
        src_kept = (all(torch.equal(a, b) for a, b in zip(page_bytes(eng, [src]), before))
                    if evicted3 == 0 else None)
        clone_checks.append({"at_clone": same, "rows_kept": kept,
                             "source_unchanged": src_kept})
    clone_checks_all = [c[3] for c in clones]
    del eng._prefill_pack
    if eng._pcache is not None:
        del eng._clone_page
    pk = {k: m1["packed_prefill"][k] - m0["packed_prefill"][k]
          for k in m1["packed_prefill"]}
    steps = m1["decode"]["steps"] - m0["decode"]["steps"]
    if len(turn1) != TURN_NEW or len(turn2) != TURN_NEW or len(turn3) != TURN_NEW or any(
            len(u) != UNRELATED_NEW for u in unrelated):
        raise AssertionError(f"{tag} stream lengths: {len(turn1)}, {len(turn2)}, "
                             f"{[len(u) for u in unrelated]}")
    if pk["kernel_fallback"] != 0:
        raise AssertionError(f"{tag} K2 shape fallbacks: {pk['kernel_fallback']}")
    dk = DECODE_KERNEL[config]
    if launches[dk] != LLAMA31_8B["num_hidden_layers"] * steps:
        raise AssertionError(f"{tag} turn 2: {dk} launched {launches[dk]} times "
                             f"over {steps} decode steps (graph replays)")
    pc = m1.get("prefix_cache", {})
    pc0 = m0.get("prefix_cache", {})
    clones3 = (eng.metrics().get("prefix_cache", {}).get("cow_clones", 0)
               - pc.get("cow_clones", 0))
    return {"p1": p1, "p2": p2, "p3": p3,
            "turn1": turn1, "unrelated": unrelated, "turn2": turn2,
            "turn3": turn3, "turn3_reused": last3.timings["reused_prompt_tokens"],
            "turn3_cow_clones": clones3,
            "turn3_k2_launches": {k: launches3[k] for k in (
                "ragged_prefill_attention", "ragged_prefill_attention_int8")},
            "p2_tokens": len(p2), "reused": last.timings["reused_prompt_tokens"],
            "ttft_ms": ttft2, "packs": pk["dispatches"],
            "continued_packs": pk["continued"],
            "pack_ms": pk["seconds"] / max(1, pk["dispatches"]) * 1e3,
            "decode_steps": steps,
            "k2_launches": {k: launches[k] for k in ("ragged_prefill_attention",
                                                     "ragged_prefill_attention_int8")},
            "decode_launches": launches[dk],
            "tier3_hits": pc.get("hits", 0) - pc0.get("hits", 0),
            "prefix_cache": pc, "kv_pages_retained": m1["kv_pages_retained"],
            "prompt_tokens_reused": m1["prompt_tokens_reused"],
            "turn2_logits": firsts["turn2"], "turn3_logits": firsts["turn3"],
            "turn1_pages": turn1_pages, "spliced": spliced,
            "turn3_clone_checks": clone_checks,
            "clones_equal_at_clone": clone_checks_all,
            "wave_peak_pages": peak[0], "m0": m0, "m1": m1,
            "trace": trace_split(box["prof"], pk["dispatches"]) if trace else None}


def prefix_phase(lm, card: str, config: str) -> dict:
    """Phase 3c on the loaded model (module doc): the sequence on an engine
    with kv_prefix_cache on, one with it off, one with the pool cut to
    PRESSURE_PAGES and the host tier off (the device tier's eviction path),
    then on and off again with turn 2's prefill traced, then off with
    prefill_chunk RECHUNK, one after the other. Returns (the phase's
    summary, the runs: phase 3g reads them)."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine

    tag = f"[prefix {config}]"
    runs = {}
    for name, knobs in (("on", {"kv_prefix_cache": True}),
                        ("off", {"kv_prefix_cache": False}),
                        ("pressure", {"kv_prefix_cache": True, "kv_offload": False,
                                      "kv_pool_pages": PRESSURE_PAGES}),
                        ("on_traced", {"kv_prefix_cache": True}),
                        ("off_traced", {"kv_prefix_cache": False}),
                        ("off_rechunk", {"kv_prefix_cache": False,
                                         "prefill_chunk": RECHUNK})):
        eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                     dataclasses.replace(lm.engine.ecfg, **knobs), device=DEV).start()
        try:
            t0 = time.monotonic()
            runs[name] = prefix_sequence(
                lm, eng, f"{tag} {name}", config, trace=name.endswith("traced"),
                turn1_ref=runs["on"]["turn1_pages"] if name == "pressure" else None)
            log(f"{tag} {name}: sequence done in {time.monotonic() - t0:.1f} s")
        finally:
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    on, off, pr = runs["on"], runs["off"], runs["pressure"]
    full_pages = (TURN1_TOKENS + TURN_NEW - 1) // PG * PG    # turn 1's committed rows
    for key in ("turn1", "unrelated", "turn2"):
        if on[key] != off[key]:
            raise AssertionError(f"{tag} greedy tokens differ on and off: {key}")
    if on["reused"] < full_pages or on["tier3_hits"] != 1:
        raise AssertionError(f"{tag} turn 2 reused {on['reused']} rows through "
                             f"{on['tier3_hits']} tier-3 hits; expected >= "
                             f"{full_pages} through one")
    if off["reused"] != 0 or off["prompt_tokens_reused"] != 0:
        raise AssertionError(f"{tag} reuse with kv_prefix_cache off: {off['reused']}")
    k2 = PREFIX_K2[config]
    if on["k2_launches"][k2] <= 0 or on["continued_packs"] != on["packs"]:
        raise AssertionError(f"{tag} turn 2's continued pack launched "
                             f"{on['k2_launches']}, packs {on['packs']} "
                             f"({on['continued_packs']} continued)")
    if (on["turn3_reused"] != TURN3_REUSE or on["turn3_cow_clones"] < 1
            or on["turn3_k2_launches"][k2] <= 0 or off["turn3_reused"] != 0):
        raise AssertionError(f"{tag} turn 3: reused {on['turn3_reused']} rows "
                             f"(off {off['turn3_reused']}), "
                             f"{on['turn3_cow_clones']} COW clones, K2 "
                             f"{on['turn3_k2_launches']}; expected {TURN3_REUSE} "
                             f"rows (off 0), >= 1 clone, {k2} launched")
    evicted = pr["prefix_cache"]["evicted_pages"]
    if evicted <= 0:
        raise AssertionError(f"{tag} the pressure run ({PRESSURE_PAGES} pages) "
                             f"evicted nothing")
    # the reused pages on the card: turn 2's are turn 1's bytes (the
    # pressure run's against the on run's copy), and every clone copied its
    # source; turn 3's clone kept its reused rows and left its source alone
    for name, want in (("on", full_pages // PG), ("pressure", pr["reused"] // PG)):
        n, same = runs[name]["spliced"]
        if n != want or not same:
            raise AssertionError(f"{tag} {name}: the {n} pages turn 2 reused "
                                 f"(expected {want}) hold "
                                 f"{'turn 1' if same else 'other'} bytes")
        if not all(runs[name]["clones_equal_at_clone"]):
            raise AssertionError(f"{tag} {name}: a COW clone differs from its "
                                 f"source: {runs[name]['clones_equal_at_clone']}")
    c3 = on["turn3_clone_checks"]
    if not c3 or not all(c["at_clone"] and c["rows_kept"] and c["source_unchanged"]
                         for c in c3):
        raise AssertionError(f"{tag} turn 3's clone(s): {c3}")
    # first-token logits against the cold run's: (max abs err, relative L2
    # err); the reuse runs' must stay within PREFIX_LOGITS_RTOL, and a cold
    # run with other chunks (no reuse) shows what chunking alone moves
    logit_errs, same_first = {}, {}
    for name, key in (("on", "turn2"), ("on", "turn3"), ("pressure", "turn2"),
                      ("pressure", "turn3"), ("off_rechunk", "turn2"),
                      ("off_rechunk", "turn3")):
        a, b = runs[name][key + "_logits"], off[key + "_logits"]
        same_first[f"{name}_{key}"] = bool(a.argmax() == b.argmax())
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} {name} {key}: non-finite logits")
        logit_errs[f"{name}_{key}"] = (max_err(a, b),
                                       float((a - b).norm() / b.norm()))
    bad = {k: v for k, v in logit_errs.items()
           if not k.startswith("off") and not v[1] <= PREFIX_LOGITS_RTOL}
    if bad:
        raise AssertionError(f"{tag} first-token logits vs off: relative L2 "
                             f"err above {PREFIX_LOGITS_RTOL}: {bad}")
    agree = sum(a == b for a, b in zip(pr["turn2"], off["turn2"]))
    log(f"{tag} {card}: turn 2 ({on['p2_tokens']}-token prompt): reused "
        f"{on['reused']} rows on (tier 3, >= {full_pages}) vs {off['reused']} off; "
        f"TTFT {on['ttft_ms']:.2f} ms on vs {off['ttft_ms']:.2f} ms off (host clock, "
        f"submit to first token); packed prefill {on['packs']} pack(s) at "
        f"{on['pack_ms']:.2f} ms/pack on vs {off['packs']} at {off['pack_ms']:.2f} "
        f"ms/pack off; {k2} launches on {on['k2_launches'][k2]}, decode "
        f"{on['decode_launches']} = {LLAMA31_8B['num_hidden_layers']} x "
        f"{on['decode_steps']} steps; greedy tokens "
        f"identical on and off (turn 1, the {UNRELATED} unrelated, turn 2); "
        f"turn 3 reused {on['turn3_reused']} rows (tier 1) with "
        f"{on['turn3_cow_clones']} COW clone(s), {k2} launches "
        f"{on['turn3_k2_launches'][k2]}; its tokens agree with the cold run on "
        f"{sum(a == b for a, b in zip(on['turn3'], off['turn3']))} of {TURN_NEW}")
    for way in ("on", "off"):
        r, tr = runs[way + "_traced"], runs[way + "_traced"]["trace"]
        if r["turn2"] != on["turn2"]:
            raise AssertionError(f"{tag} {way}_traced: turn 2's tokens differ")
        log(f"{tag} {card}: {way}: turn 2 from submit to first token under "
            f"torch.profiler: {r['ttft_ms']:.2f} ms (untraced {runs[way]['ttft_ms']:.2f}); "
            + (f"device busy {tr['device_busy_ms']:.2f} ms ({tr['busy_share'] * 100:.1f}% "
               f"of the window), {tr['kernels_per_step'] * r['packs']:.0f} CUDA kernels in "
               f"{r['packs']} pack(s), first device activity after "
               f"{tr['lead_in_ms']:.2f} ms; {tr['gaps_over_20us']} idle gaps over 20 us, "
               f"{tr['gaps_over_20us_ms']:.2f} ms in all; top kernels "
               f"{json.dumps(tr['top10'][:5])}"
               if tr else "the profiler recorded no device activity (not measured)"))
    log(f"{tag} {card}: prefix cache on {json.dumps(on['prefix_cache'])}; "
        f"pressure run ({PRESSURE_PAGES} pages): turn 2 reused {pr['reused']} rows, "
        f"evicted {evicted} pages, COW clones {pr['prefix_cache']['cow_clones']}, "
        f"TTFT {pr['ttft_ms']:.2f} ms, {pr['packs']} packs; its turn 2 agrees with "
        f"the cold run on {agree} of {TURN_NEW} tokens")
    log(f"{tag} reused pages on the card: turn 2's {full_pages // PG} (on) and "
        f"{pr['reused'] // PG} (pressure) pages byte-equal to turn 1's; turn 3's "
        f"clone {json.dumps(c3)}; first-token logits vs off, (max abs err, "
        f"relative L2 err): "
        f"{json.dumps({k: [f'{e:.3e}' for e in v] for k, v in logit_errs.items()})} "
        f"(reuse runs' tol {PREFIX_LOGITS_RTOL} relative L2; off_rechunk = "
        f"reuse off, prefill_chunk {RECHUNK}; max |logit| off "
        f"{float(off['turn3_logits'].abs().max()):.3f})")
    # a first token that differs from the cold run's is a near-tie when the
    # cold run's top two logits lie within the logits' error of each other
    margins = {k: float(t[0] - t[1]) for k, t in (
        (k, off[k + "_logits"].topk(2).values) for k in ("turn2", "turn3"))}
    log(f"{tag} first token vs off, same argmax: {json.dumps(same_first)}; the "
        f"cold run's top-2 logit margin: turn 2 {margins['turn2']:.4f}, turn 3 "
        f"{margins['turn3']:.4f}")
    keep = ("p2_tokens", "reused", "ttft_ms", "packs", "continued_packs", "pack_ms",
            "decode_steps", "k2_launches", "decode_launches", "tier3_hits",
            "turn3_reused", "turn3_cow_clones", "turn3_k2_launches",
            "prefix_cache", "kv_pages_retained", "trace")
    out = {name: {k: r[k] for k in keep} for name, r in runs.items()}
    out["pressure"]["turn2_agreement_with_off"] = agree
    out["first_token_logits_err"] = logit_errs
    out["first_token_same"] = same_first
    out["cold_top2_margin"] = margins
    out["shape_witness"] = shape_witness(lm, runs, tag)
    return out, runs


def shape_witness(lm, runs, tag: str) -> dict:
    """The open bf16 check (module doc, phase 3c): first-token logits of
    exact-size eager packs (``Engine._prefill_eager(exact=True)``, the
    shapes every pack had before the buckets) on a fresh engine's cache,
    for turn 3 and the pressure run's turn 2: "cold" = a cold run's packs;
    "reuse" = the packs that wrote the rows the reuse run holds (turn 1's,
    turn 2's), then its last pack; "witness" = a cold run whose last pack
    has the reuse run's shape. Returns (max abs err, relative L2 err,
    same argmax) for each pair."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine
    from localai_tpu_torch.engine.prefill_graph import new_pack, split_pack

    on, pr = runs["on"], runs["pressure"]
    p1, p2, p3 = on["p1"], on["p2"], on["p3"]
    # not started: no graphs, only the exact-size eager reference
    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                 dataclasses.replace(lm.engine.ecfg, kv_prefix_cache=False),
                 device=DEV)
    chunk = lm.engine.ecfg.prefill_chunk

    def chunks(ids, upto, start=0):
        return [(ids, a, min(chunk, upto - a)) for a in range(start, upto, chunk)]

    def first_logits(packs):
        eng._pool.ensure(0, max(a + n for _ids, a, n in packs))
        eng._commit_ptab()
        for i, (ids, start, n) in enumerate(packs):
            host = new_pack(n, S_SLOTS, C_MAX)
            v = split_pack(host, n, S_SLOTS)
            v["tokens"][:] = ids[start:start + n]
            v["positions"][:] = range(start, start + n)
            v["seg_of"][:] = 0
            v["seg_slots"][0], v["seg_start"][0], v["seg_len"][0] = 0, start, n
            v["final_mask"][0] = i == len(packs) - 1
            _out, logits = eng._prefill_eager(n, start > 0, host, exact=True)
        return logits[0].float().clone()

    r2, r3, rp = on["reused"], on["turn3_reused"], pr["reused"]
    cases = {
        "turn3": {"cold": chunks(p3, len(p3)),
                  "reuse": chunks(p1, len(p1)) + [(p2, r2, len(p2) - r2),
                                                  (p3, r3, len(p3) - r3)],
                  "witness": chunks(p3, r3) + [(p3, r3, len(p3) - r3)]},
        "pressure_turn2": {"cold": chunks(p2, len(p2)),
                           "reuse": chunks(p1, len(p1)) + [(p2, rp, len(p2) - rp)],
                           "witness": chunks(p2, rp) + [(p2, rp, len(p2) - rp)]},
    }
    out = {}
    try:
        for case, scheds in cases.items():
            lg = {k: first_logits(v) for k, v in scheds.items()}
            shapes = {k: [n for _i, _a, n in v] for k, v in scheds.items()}
            errs = {}
            for a, b in (("witness", "reuse"), ("witness", "cold"), ("reuse", "cold")):
                x, y = lg[a], lg[b]
                errs[f"{a}_vs_{b}"] = (max_err(x, y), float((x - y).norm() / y.norm()),
                                       bool(x.argmax() == y.argmax()))
            out[case] = {"packs": shapes, "errs": errs}
            log(f"{tag} shape witness, {case}: exact-size packs {json.dumps(shapes)}; "
                f"first-token logits (max abs err, relative L2 err, same argmax): "
                f"{json.dumps({k: [f'{v[0]:.3e}', f'{v[1]:.3e}', v[2]] for k, v in errs.items()})}")
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------- phase 3g: the host tier ----------


def memory_phase(lm, card: str, config: str, gb: float) -> dict:
    """Card memory after load with the host tier (the default, measured
    at load: ``gb``) and without it: an unstarted Engine of each kind is
    built beside the loaded one and its allocation measured; the two
    differ only in the KV pool (the default pool cut), so memory after
    load without the tier is ``gb`` less the first plus the second."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine

    out = {}
    for name, on in (("on", True), ("off", False)):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                     dataclasses.replace(lm.engine.ecfg, kv_offload=on),
                     device=DEV)
        torch.cuda.synchronize()
        out[name] = {"engine_gb": (torch.cuda.memory_allocated() - before) / 1e9,
                     "pages": eng.metrics().get("pages_total")}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["after_load_on_gb"] = gb
    out["after_load_off_gb"] = gb - out["on"]["engine_gb"] + out["off"]["engine_gb"]
    out["freed_gb"] = out["off"]["engine_gb"] - out["on"]["engine_gb"]
    paged = lm.engine.kv_layout == "paged"
    if paged != (out["freed_gb"] > 0) or (paged and out["on"]["pages"] * 4
                                         != out["off"]["pages"] * 3):
        raise AssertionError(f"[memory {config}] the default pool cut: {out}")
    log(f"[memory {config}] {card}: memory_allocated after load {gb:.3f} GB with "
        f"the host tier (pool {out['on']['pages']} pages), "
        f"{out['after_load_off_gb']:.3f} GB without (pool {out['off']['pages']}): "
        f"{out['freed_gb']:.3f} GB freed (engine state {out['on']['engine_gb']:.3f} "
        f"vs {out['off']['engine_gb']:.3f} GB, measured on unstarted engines)")
    return out


def serve_one(lm, eng, ids, n: int, tag: str) -> tuple:
    """One greedy request (ignore_eos) submitted to ``eng``: (tokens, TTFT
    ms on the host clock from submit, the last event)."""
    from localai_tpu_torch.backend import runner

    req = runner.build_request(lm, "", {"ignore_eos": True, "temperature": 0,
                                        "max_tokens": n})
    req.prompt_ids = list(ids)
    t0, t_first, out_ids, last = time.monotonic(), None, [], None
    out = eng.submit(req)
    while (ev := out.get(timeout=300)) is not None:
        if ev.error:
            raise AssertionError(f"{tag}: {ev.error}")
        t_first = t_first or time.monotonic()
        out_ids.extend(ev.token_ids or [ev.token_id])
        last = ev
    return out_ids, (t_first - t0) * 1e3, last


def host_probe(eng) -> dict:
    """Time an engine's host-tier calls, on its thread, while ``st["on"]``:
    host ms in HostPageStore.get (the CRC included), host ms in
    _upload_pages (staging into pinned memory, queueing the copies) with
    CUDA events around each upload, and host ms in _dispatch_offload
    (the gather of the evicted pages on the card queued)."""
    import torch

    st = {"on": False, "gets": 0, "get_ms": 0.0, "uploads": [],
          "upload_host_ms": 0.0, "offloaded": 0, "offload_host_ms": 0.0}
    get, upload, offload = (eng._hstore.get, eng._upload_pages,
                            eng._dispatch_offload)

    def get_probe(key):
        t = time.perf_counter()
        e = get(key)
        if st["on"]:
            st["gets"] += 1
            st["get_ms"] += (time.perf_counter() - t) * 1e3
        return e

    def upload_probe(pages, hits):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        upload(pages, hits)
        b.record()
        if st["on"]:
            st["upload_host_ms"] += (time.perf_counter() - t) * 1e3
            st["uploads"].append((a, b, len(hits)))

    def offload_probe(victims):
        t = time.perf_counter()
        offload(victims)
        if st["on"]:
            st["offloaded"] += len(victims)
            st["offload_host_ms"] += (time.perf_counter() - t) * 1e3

    eng._hstore.get = get_probe
    eng._upload_pages = upload_probe
    eng._dispatch_offload = offload_probe
    return st


def probe_result(st) -> dict:
    import torch

    torch.cuda.synchronize()
    return {"gets": st["gets"], "get_ms": st["get_ms"],
            "uploaded_pages": sum(n for _a, _b, n in st["uploads"]),
            "upload_ms": sum(a.elapsed_time(b) for a, b, _n in st["uploads"]),
            "upload_host_ms": st["upload_host_ms"],
            "offloaded_pages": st["offloaded"],
            "offload_host_ms": st["offload_host_ms"]}


def host_tier_phase(lm, card: str, config: str, runs: dict) -> dict:
    """Phase 3g on the loaded model (module doc), after 3c, whose runs
    ``runs`` it reads: the 96-page pressure run at the defaults (host tier
    on), the evict-all run (a pool the wave alone fills), and the reload
    (the store saved at shutdown, a fresh engine restoring turn 2 from
    the file)."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine

    tag = f"[host {config}]"
    on, off = runs["on"], runs["off"]
    chain = (TURN1_TOKENS + TURN_NEW - 1) // PG          # turn 1's full pages
    evict_all = on["wave_peak_pages"]
    store_dir = os.path.join(ROOT, "build", "chip_smoke", "host_store")
    os.makedirs(store_dir, exist_ok=True)
    path = os.path.join(store_dir, f"{config}.npz")
    if os.path.exists(path):
        os.remove(path)

    def engine(**knobs):
        return Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                      dataclasses.replace(lm.engine.ecfg, **knobs),
                      device=DEV).start()

    out = {"chain_pages": chain, "evict_all_pool": evict_all}
    for name, pages in (("pressure", PRESSURE_PAGES), ("evict_all", evict_all)):
        eng = engine(kv_pool_pages=pages)
        st = host_probe(eng)
        before = {}

        def turn2_starts(eng=eng, st=st, before=before):
            eng._offloader.join()            # the wave's offloads landed
            p1 = on["p1"]
            before["device_links"] = len(chain_pages(eng, p1))
            before["host_links"] = sum(eng._hstore.contains(k) for k in
                                       list(eng._pcache.chain_keys(p1))[:chain])
            st["on"] = True

        def turn2_ends(st=st):
            st["on"] = False

        t0 = time.monotonic()
        try:
            r = prefix_sequence(lm, eng, f"{tag} {name}", config,
                                turn1_ref=on["turn1_pages"],
                                before_turn2=turn2_starts, after_turn2=turn2_ends)
            eng._offloader.join()
            m = eng.metrics()
        finally:
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        kv0, kv1 = r["m0"]["kv_offload"], r["m1"]["kv_offload"]
        res = {"reused": r["reused"], "ttft_ms": r["ttft_ms"], "packs": r["packs"],
               "pack_ms": r["pack_ms"], "turn2_same_as_on": r["turn2"] == on["turn2"],
               "spliced": list(r["spliced"]), **before,
               "turn2_restored_pages": kv1["restored_pages"] - kv0["restored_pages"],
               "turn2_restores": kv1["restores"] - kv0["restores"],
               "turn2": probe_result(st), "kv_offload": m["kv_offload"],
               "worker": m["kv_offload_worker"], "evicted_pages":
               m["prefix_cache"]["evicted_pages"], "turn1": r["turn1"],
               "turn2_tokens": r["turn2"], "p2": r["p2"]}
        w = res["worker"]
        res["worker_ms_per_page"] = w["seconds"] / max(1, w["pages"]) * 1e3
        out[name] = res
        log(f"{tag} {name}: sequence done in {time.monotonic() - t0:.1f} s")
        if (r["reused"] < chain * PG or not r["spliced"][1]
                or r["spliced"][0] != r["reused"] // PG or not res["turn2_same_as_on"]
                or res["turn2_restored_pages"] <= 0):
            raise AssertionError(f"{tag} {name}: turn 2 reused {r['reused']} rows "
                                 f"(>= {chain * PG}), restored "
                                 f"{res['turn2_restored_pages']} pages, reused pages "
                                 f"{r['spliced']} (count, equal to turn 1's), tokens "
                                 f"equal to the on run's: {res['turn2_same_as_on']}")
    ea = out["evict_all"]
    if (ea["device_links"] != 0 or ea["host_links"] != chain
            or ea["turn2_restored_pages"] != chain):
        raise AssertionError(f"{tag} evict_all: before turn 2 {ea['device_links']} "
                             f"links on the card, {ea['host_links']} in the host "
                             f"tier; turn 2 restored {ea['turn2_restored_pages']} "
                             f"(expected 0, {chain}, {chain})")
    # reload: engine A runs turn 1 and the wave and saves at shutdown;
    # engine B loads the file and serves turn 2 alone
    eng = engine(kv_pool_pages=evict_all, kv_host_store_path=path)
    try:
        ra = prefix_sequence(lm, eng, f"{tag} reload A", config, upto="wave")
    finally:
        t0 = time.perf_counter()
        eng.shutdown()
        save_s = time.perf_counter() - t0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    file_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    eng = engine(kv_pool_pages=evict_all, kv_host_store_path=path)
    start_s = time.perf_counter() - t0
    try:
        loaded = eng.metrics()["kv_offload"]["pages"]
        turn2, ttft, last = serve_one(lm, eng, ea["p2"], TURN_NEW, f"{tag} reload B")
        mb = eng.metrics()["kv_offload"]
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(path)
    out["reload"] = {"loaded_pages": loaded, "file_mb": file_mb,
                     "shutdown_save_s": save_s, "start_load_s": start_s,
                     "ttft_ms": ttft, "reused": last.timings["reused_prompt_tokens"],
                     "restored_pages": mb["restored_pages"],
                     "turn2_same_as_evict_all": turn2 == ea["turn2_tokens"]}
    rl = out["reload"]
    if (ra["turn1"] != ea["turn1"] or loaded < chain or rl["restored_pages"] != chain
            or not rl["turn2_same_as_evict_all"]):
        raise AssertionError(f"{tag} reload: A's turn 1 as evict_all's "
                             f"{ra['turn1'] == ea['turn1']}, {loaded} pages loaded, "
                             f"{rl['restored_pages']} restored (expected {chain}), "
                             f"turn 2 as evict_all's {rl['turn2_same_as_evict_all']}")
    pr = out["pressure"]
    log(f"{tag} {card}: pressure ({PRESSURE_PAGES} pages, host tier on): before turn "
        f"2 {pr['device_links']} of turn 1's {chain} links on the card, "
        f"{pr['host_links']} in the host tier; turn 2 reused {pr['reused']} rows, "
        f"{pr['turn2_restored_pages']} pages restored, pages byte-equal to turn 1's, "
        f"tokens equal to the on run's; TTFT {pr['ttft_ms']:.2f} ms (on "
        f"{on['ttft_ms']:.2f}, off {off['ttft_ms']:.2f}); in turn 2's admission: "
        f"{pr['turn2']['gets']} gets {pr['turn2']['get_ms']:.2f} ms host (CRC "
        f"included), upload {pr['turn2']['upload_ms']:.2f} ms device (CUDA events) / "
        f"{pr['turn2']['upload_host_ms']:.2f} ms host, {pr['turn2']['offloaded_pages']} "
        f"pages offloaded in {pr['turn2']['offload_host_ms']:.2f} ms host")
    log(f"{tag} {card}: evict-all ({evict_all} pages, the wave's peak): all {chain} "
        f"links offloaded, turn 2 restored {ea['turn2_restored_pages']}: TTFT "
        f"{ea['ttft_ms']:.2f} ms vs {off['ttft_ms']:.2f} off (cold prefill) and "
        f"{on['ttft_ms']:.2f} on (device tier, nothing evicted); {ea['packs']} "
        f"pack(s) at {ea['pack_ms']:.2f} ms; {ea['turn2']['gets']} gets "
        f"{ea['turn2']['get_ms']:.2f} ms host (CRC included), upload "
        f"{ea['turn2']['upload_ms']:.2f} ms device (CUDA events) / "
        f"{ea['turn2']['upload_host_ms']:.2f} ms host for "
        f"{ea['turn2']['uploaded_pages']} pages; {ea['turn2']['offloaded_pages']} "
        f"pages offloaded during turn 2 in {ea['turn2']['offload_host_ms']:.2f} ms "
        f"host; tokens equal to the on run's")
    log(f"{tag} {card}: offload worker {ea['worker']['pages']} pages in "
        f"{ea['worker']['batches']} batches, {ea['worker_ms_per_page']:.3f} ms per "
        f"page after the copies landed (CRC, insert; pressure run "
        f"{pr['worker_ms_per_page']:.3f}); evict-all stats {json.dumps(ea['kv_offload'])}")
    log(f"{tag} {card}: reload: A saved {file_mb:.1f} MB at shutdown in "
        f"{save_s:.2f} s; B started (graphs captured, file loaded) in {start_s:.2f} s "
        f"with {loaded} pages; B's turn 2 reused {rl['reused']} rows, restored "
        f"{rl['restored_pages']} pages, TTFT {rl['ttft_ms']:.2f} ms, tokens equal to "
        f"evict-all's")
    for name in ("pressure", "evict_all"):
        for k in ("turn1", "turn2_tokens", "p2"):
            del out[name][k]
    out["race"] = race_counts(lm, config, kv_offload=True)
    return out


# the host-tier race arrangement (scripts/host_tier_race.py's first-token
# way, its sizes times PG / 16): a 20-page pool, turn 1, a wave of four
# each submitted once the one before has its first token, turn 2, a second
# wave, turn 3
RACE_POOL = 20
RACE_SCALE = PG // 16


def race_counts(lm, config: str, kv_offload: bool) -> dict:
    """The race arrangement on an engine of its own over the loaded weights
    (speculation off, the emitter on: the top-of-tick drain runs): the rows
    turns 2 and 3 reused. Printed, not gated: which of a release and an
    admission comes first is the card's timing."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    tag = f"[race {config}]"
    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer, dataclasses.replace(
        lm.engine.ecfg, kv_pool_pages=RACE_POOL, kv_offload=kv_offload,
        draft="0", emitter=True), device=DEV).start()
    rng = np.random.default_rng(SEED + 31)
    k = RACE_SCALE

    def draw(n):
        return rng.integers(1000, 100000, n).tolist()

    def submit(ids, n):
        return eng.submit(GenRequest(prompt_ids=list(ids), max_new_tokens=n,
                                     ignore_eos=True,
                                     params=SamplingParamsHost(temperature=0.0)))

    def drain(out, first=None):
        ids, last = [], None
        while (ev := first or out.get(timeout=600)) is not None:
            first = None
            if ev.error:
                raise AssertionError(f"{tag} {ev.error}")
            ids.extend(ev.token_ids or [ev.token_id])
            last = ev
        return ids, last.timings["reused_prompt_tokens"]

    def wave(lens, n):
        outs = []
        for m in lens:
            out = submit(draw(m * k), n)
            outs.append((out, out.get(timeout=600)))     # its first token
        return [drain(o, f) for o, f in outs]

    t0 = time.monotonic()
    try:
        a = draw(70 * k)
        res = [drain(submit(a, 6))]
        res += wave((60, 62, 58, 61), 10)
        t2 = a + res[0][0] + draw(5 * k)
        res.append(drain(submit(t2, 6)))
        res += wave((63, 57, 60, 59), 10)
        res.append(drain(submit(t2 + res[5][0] + draw(7 * k), 6)))
        m = eng.metrics()
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out = {"turn2_reused": res[5][1], "turn3_reused": res[10][1],
           "reused": [r[1] for r in res], "pool_pages": RACE_POOL,
           "kv_offload": kv_offload,
           "evicted_pages": m["prefix_cache"]["evicted_pages"],
           "seconds": round(time.monotonic() - t0, 1)}
    log(f"{tag} kv_offload {int(kv_offload)}: turn 2 / turn 3 reused "
        f"{out['turn2_reused']} / {out['turn3_reused']} rows (turn 1 {len(a)} "
        f"tokens, waves fed one request per first token, a {RACE_POOL}-page pool; "
        f"every request's reused rows {out['reused']}; {out['evicted_pages']} "
        f"pages evicted; {out['seconds']} s with the engine's start)")
    return out


# ---------- phase 3e: context shift ----------

SHIFT_CONTEXT = 1024         # the second engine's max_context
SHIFT_PROMPT = 300           # prompt tokens
SHIFT_TOKENS = 1300          # max_tokens: two shifts at context 1024 (the
                             # second at token ~1233)


def shift_phase(lm, card: str, config: str) -> dict:
    """Phase 3e on the loaded model: a second engine over the same weights
    (context SHIFT_CONTEXT, chunk 512, the configuration's KV) serves one
    greedy request of SHIFT_PROMPT prompt tokens and SHIFT_TOKENS new
    ones (ignore_eos), which crosses the cache edge: it must finish with
    "length" after SHIFT_TOKENS tokens and shift at least twice, counted
    from the packed_prefill dispatches beyond its first pack. The launch
    counters are zeroed just before the request and read just after: the
    decode kernel runs 32 x decode steps and K2 32 x packs, all through
    the graphs. Each shift's stall is the host-clock time from the event
    holding the trigger token to the one holding the next token (the
    re-prefill's first), beside the median time between the request's
    other events (one decode burst each)."""
    import dataclasses
    import statistics

    import torch

    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tag = f"[shift {config}]"
    n_layers = LLAMA31_8B["num_hidden_layers"]
    dk = DECODE_KERNEL[config]
    head = "A long story about a lighthouse keeper and the sea. "
    prompt = lm.tokenizer.encode((head * 8)[:SHIFT_PROMPT])
    assert len(prompt) == SHIFT_PROMPT, len(prompt)
    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer, dataclasses.replace(
        lm.engine.ecfg, max_context=SHIFT_CONTEXT, prefill_chunk=512),
        device=DEV).start()
    try:
        triggers = []                         # n_decoded at each shift
        shift = eng._context_shift

        def spy(slot, s, token_id):
            triggers.append(s.n_decoded)
            return shift(slot, s, token_id)

        eng._context_shift = spy
        m0 = eng.metrics()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.monotonic()
        out = eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=SHIFT_TOKENS,
                                    ignore_eos=True,
                                    params=SamplingParamsHost(temperature=0.0)))
        events, last = [], None               # (arrival, tokens so far)
        n = 0
        while (ev := out.get(timeout=600)) is not None:
            if ev.error:
                raise AssertionError(f"{tag} {ev.error}")
            n += len(ev.token_ids or [ev.token_id])
            events.append((time.monotonic(), n))
            last = ev
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        m1 = eng.metrics()
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    packs = m1["packed_prefill"]["dispatches"] - m0["packed_prefill"]["dispatches"]
    steps = m1["decode"]["steps"] - m0["decode"]["steps"]
    shifts = packs - 1                        # the prompt fits one pack
    if (last.finish_reason != "length" or last.completion_tokens != SHIFT_TOKENS
            or n != SHIFT_TOKENS):
        raise AssertionError(f"{tag} finished {last.finish_reason!r} after "
                             f"{last.completion_tokens} tokens ({n} streamed)")
    if shifts < 2 or len(triggers) != shifts:
        raise AssertionError(f"{tag} {shifts} shifts by the pack count "
                             f"({packs} packs), {len(triggers)} shift calls")
    k2 = launched["ragged_prefill_attention"] + launched["ragged_prefill_attention_int8"]
    if launched[dk] != n_layers * steps or k2 != n_layers * packs:
        raise AssertionError(f"{tag} {dk} launched {launched[dk]} times over "
                             f"{steps} steps, K2 / K2-int8 {k2} over {packs} packs")
    stalls = []
    for k in triggers:                        # the trigger is token k (1-based)
        i = next(j for j, (_t, c) in enumerate(events) if c >= k)
        stalls.append((events[i + 1][0] - events[i][0]) * 1e3)
    gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(events, events[1:])]
    burst_ms = statistics.median(gaps)
    log(f"{tag} {card}: context {SHIFT_CONTEXT}, {SHIFT_PROMPT}-token prompt, "
        f"{SHIFT_TOKENS} greedy tokens in {wall:.2f} s: finish "
        f"{last.finish_reason}, {shifts} shifts at tokens {triggers} "
        f"({packs} packs, {steps} decode steps); stall of each shift (host "
        f"clock, trigger token's event to the next token's): "
        f"{', '.join(f'{x:.2f}' for x in stalls)} ms; median time between "
        f"the request's events {burst_ms:.2f} ms; {dk} {launched[dk]} = "
        f"{n_layers} x {steps}, K2 {k2} = {n_layers} x {packs}")
    return {"shifts": shifts, "triggers": triggers, "stall_ms": stalls,
            "between_events_ms": burst_ms, "packs": packs, "steps": steps,
            "seconds": wall}


# ---------- phase 3f: the pipelined loop ----------

# the synchronous loop the pipelined one is held against
PIPE_SYNC = {"pipeline_depth": 1, "prefill_packed_fuse": "0"}
# (a) byte gate: (prompt tokens, max_tokens, EOS forced by logit_bias)
PIPE_GATE = [(30, 41, False), (1500, 300, False), (200, 95, True),
             (700, 153, False), (64, 250, False), (1100, 77, True),
             (450, 203, False), (90, 121, False)]
# (b) mixed traffic: MIX_LONG generations decode while MIX_ARRIVALS long
# prompts arrive MIX_SPACING_S apart
MIX_LONG, MIX_LONG_PROMPT, MIX_LONG_TOKENS = 4, 100, 120
MIX_ARRIVALS, MIX_PROMPT, MIX_TOKENS, MIX_SPACING_S = 4, 1500, 24, 0.1
# (c) dedup: DEDUP_N identical requests against DEDUP_N whose last prompt
# token differs; first-token logits held to phase 3c's tolerance
DEDUP_N, DEDUP_PROMPT, DEDUP_TOKENS = 4, 1500, 32


def pipe_requests(specs, eos):
    """Greedy GenRequests for (prompt ids, max_tokens, EOS forced): a forced
    one sets logit_bias +100 on EOS and stops on it."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    return [GenRequest(prompt_ids=list(p), max_new_tokens=n, ignore_eos=not forced,
                       params=SamplingParamsHost(temperature=0.0, logit_bias=(
                           {eos: 100.0} if forced else {})))
            for p, n, forced in specs]


def collect(reqs, outs, tag):
    """Reader threads (not started) for the requests' streams. Each fills
    its entry of the returned list with ids, finish, completion_tokens,
    reused rows and TTFT (host clock, submit to first event), and sets its
    Event at the first event."""
    res = [None] * len(outs)
    firsts = [threading.Event() for _ in outs]

    def read(i, req, out):
        ids, last, t_first = [], None, None
        while (ev := out.get(timeout=600)) is not None:
            if ev.error:
                res[i] = AssertionError(f"{tag} request {i}: {ev.error}")
                firsts[i].set()
                return
            if t_first is None:
                t_first = time.monotonic()
                firsts[i].set()
            ids.extend(ev.token_ids or [ev.token_id])
            last = ev
        res[i] = {"rid": req.request_id, "ids": ids, "finish": last.finish_reason,
                  "completion_tokens": last.completion_tokens,
                  "reused": last.timings["reused_prompt_tokens"],
                  "ttft_ms": (t_first - req.t_submit) * 1e3,
                  "itl_ms": (time.monotonic() - t_first) * 1e3
                  / max(1, last.completion_tokens - 1)}

    threads = [threading.Thread(target=read, args=(i, r, o), daemon=True)
               for i, (r, o) in enumerate(zip(reqs, outs))]
    return res, threads, firsts


def finish(res, threads, tag):
    for t in threads:
        t.join(timeout=900)
    for r in res:
        if not isinstance(r, dict):
            raise r or AssertionError(f"{tag} a request did not end")
    return res


def run_together(eng, reqs, tag):
    """Queue every request before the loop admits any (admission held),
    then let it run; the per-request results once all ended."""
    gate = threading.Event()
    admit = eng._admit
    eng._admit = lambda admit=admit, gate=gate: gate.is_set() and admit()
    try:
        res, threads, _f = collect(reqs, [eng.submit(r) for r in reqs], tag)
        for t in threads:
            t.start()
        gate.set()
        eng._wake.set()
        return finish(res, threads, tag)
    finally:
        del eng._admit


def idle_metrics(eng, tag):
    """The engine's metrics once nothing is in flight; no slot may stay
    taken and no page in use."""
    t_end = time.monotonic() + 30
    while eng.metrics()["pipeline"]["inflight"] and time.monotonic() < t_end:
        time.sleep(0.01)
    m = eng.metrics()
    if m["active_slots"] or m["pipeline"]["inflight"] or m.get("pages_in_use", 0):
        raise AssertionError(f"{tag} not idle after the run: {m['active_slots']} "
                             f"slots, {m['pipeline']['inflight']} bursts in flight, "
                             f"{m.get('pages_in_use')} pages in use")
    return m


def trace_gaps(prof):
    """Over a torch.profiler trace's ANNOTATION window: the device's busy
    share (the union of kernel, copy and memset intervals) of the window
    and of the span from its first to its last device activity (the
    window's lead-in and tail, host time at its two ends, apart), and its
    idle gaps over 20 us, each classed by the work on its two sides, told apart
    by their attention kernel (K2 in a pack, the decode kernel in a burst):
    "decode->decode" (between bursts), "pack->pack" (between a prompt's
    packs) and the mixed classes. None without device activity."""
    from torch.autograd import DeviceType

    evs = trace_events(prof)
    win = [e for e in evs if e.name == ANNOTATION and e.device_type == DeviceType.CPU]
    if not win:
        return None
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1), e.name)
                 for e in evs if e.device_type == DeviceType.CUDA
                 and e.name != ANNOTATION and e.time_range.end > t0
                 and e.time_range.start < t1)
    if not dev:
        return None
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    kind, pending, classes = None, [], {}
    for a, b, name in dev:
        if a > cur_e:
            busy += cur_e - cur_s
            if a - cur_e > 20:
                pending.append((kind, a - cur_e))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
        k = ("pack" if "ragged_prefill" in name
             else "decode" if "_split_kernel" in name else None)
        if k is not None:
            for before, g in pending:
                c = classes.setdefault(f"{before}->{k}", [0, 0.0])
                c[0] += 1
                c[1] += g / 1e3
            pending, kind = [], k
    busy += cur_e - cur_s
    span = cur_e - dev[0][0]
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / max(1e-9, t1 - t0),
            "span_ms": span / 1e3, "span_busy_share": busy / max(1e-9, span),
            "lead_in_ms": (dev[0][0] - t0) / 1e3, "tail_ms": (t1 - cur_e) / 1e3,
            "gaps_over_20us": {c: {"count": n, "ms": ms}
                               for c, (n, ms) in sorted(classes.items())}}


def mixed_run(eng, gen, tag, trace: bool = True):
    """(b): MIX_LONG generations decode; once all have their first token,
    MIX_ARRIVALS long prompts arrive MIX_SPACING_S apart. From the first
    arrival until every request ended the card runs under torch.profiler,
    started and stopped on the engine thread. Every request must end with
    completion_tokens == max_tokens."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    vocab = LLAMA31_8B["vocab_size"]
    gc.collect()              # no collection of earlier traces in the TTFTs
    longs = pipe_requests([(gen.integers(1000, vocab, MIX_LONG_PROMPT).tolist(),
                            MIX_LONG_TOKENS, False) for _ in range(MIX_LONG)], 0)
    arrivals = pipe_requests([(gen.integers(1000, vocab, MIX_PROMPT).tolist(),
                               MIX_TOKENS, False) for _ in range(MIX_ARRIVALS)], 0)
    res_l, th_l, first_l = collect(longs, [eng.submit(r) for r in longs], tag)
    for t in th_l:
        t.start()
    for f in first_l:
        f.wait(timeout=600)
    d0 = eng.metrics()["trace"].get("decomp_ms")      # the tracer's, if on
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
           record_function(ANNOTATION))
    if trace:
        on_engine_thread(eng, lambda: [c.__enter__() for c in ctx])
    res_a, th_a = [], []
    for r in arrivals:           # each read from its submit on
        res, th, _f = collect([r], [eng.submit(r)], tag)
        th[0].start()
        res_a.append(res)
        th_a += th
        time.sleep(MIX_SPACING_S)
    for t in th_a:
        t.join(timeout=900)
    res_a = finish([r[0] for r in res_a], [], tag)
    finish(res_l, th_l, tag)

    def stop():
        ctx[1].__exit__(None, None, None)
        torch.cuda.synchronize()
        ctx[0].__exit__(None, None, None)

    if trace:
        on_engine_thread(eng, stop)
    bad = [(r["completion_tokens"], len(r["ids"]), want) for r, want in
           [(r, MIX_LONG_TOKENS) for r in res_l] + [(r, MIX_TOKENS) for r in res_a]
           if r["completion_tokens"] != want or len(r["ids"]) != want]
    if bad:
        raise AssertionError(f"{tag} completion_tokens != max_tokens: {bad}")
    m = idle_metrics(eng, tag)
    d1 = m["trace"].get("decomp_ms")
    return {"ttft_ms": [r["ttft_ms"] for r in res_a],
            "trace": trace_gaps(ctx[0]) if trace else None,
            # the tracer's host / device / emitter split over the arrivals'
            # window (services/tracing.py), None with trace=False
            "decomp_ms": ({k: d1[k] - d0[k] for k in d1} if d0 and d1 else None),
            "itl_ms": [r["itl_ms"] for r in res_l], "pipeline": m["pipeline"]}


def dedup_run(eng, gen, tag):
    """(c): the control group (DEDUP_N prompts whose last token differs),
    then the identical group, each queued together on the engine with
    nothing retained (forget_retained), so only the fork can reuse rows.
    Per group: pack tokens, reused rows, TTFTs (host clock), the packs'
    device ms (CUDA events around each pack) and each request's
    first-token logits; for the identical group, the fewest references
    on the leader's full prompt pages right after its siblings forked."""
    import torch

    from localai_tpu_torch.engine.prefill_graph import split_pack

    vocab = LLAMA31_8B["vocab_size"]
    base = gen.integers(1000, vocab, DEDUP_PROMPT).tolist()
    groups = {"control": [base[:-1] + [1000 + i] for i in range(DEDUP_N)],
              "dedup": [list(base) for _ in range(DEDUP_N)]}
    out = {}
    for name, prompts in groups.items():
        on_engine_thread(eng, lambda: forget_retained(eng))
        gc.collect()          # no collection of earlier traces in the TTFTs
        logits, events, refs = {}, [], []

        def pack_probe(bucket, continued, host, run_pack=eng._prefill_pack):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f = run_pack(bucket, continued, host)
            b.record()
            events.append((a, b))
            v = split_pack(host, bucket, S_SLOTS)
            for r in range(int(v["final_mask"].sum())):
                s = eng.slots[int(v["seg_slots"][r])]
                logits[s.req.request_id] = eng._pgraph.logits[r].float().clone()
            return f

        def fork_probe(leader, lsnap, fork=eng._process_fork_waiters):
            waited = lsnap in eng._fork_waiters
            fork(leader, lsnap)
            if waited and eng._pool is not None and eng.slots[leader] is lsnap:
                full = eng._pool.ptab[leader, :(DEDUP_PROMPT - 1) // PG]
                refs.append(min(int(eng._pool.refs[p]) for p in full))

        eng._prefill_pack, eng._process_fork_waiters = pack_probe, fork_probe
        m0 = eng.metrics()
        try:
            res = run_together(eng, pipe_requests(
                [(p, DEDUP_TOKENS, False) for p in prompts], 0), f"{tag} {name}")
        finally:
            del eng._prefill_pack, eng._process_fork_waiters
        torch.cuda.synchronize()
        m1 = idle_metrics(eng, f"{tag} {name}")
        out[name] = {
            "pack_tokens": m1["packed_prefill"]["tokens"] - m0["packed_prefill"]["tokens"],
            "packs": m1["packed_prefill"]["dispatches"] - m0["packed_prefill"]["dispatches"],
            "reused": [r["reused"] for r in res], "ttft_ms": [r["ttft_ms"] for r in res],
            "prefill_device_ms": sum(a.elapsed_time(b) for a, b in events),
            "ids": [r["ids"] for r in res],
            "logits": [logits[r["rid"]] for r in res],
            "completion_tokens": [r["completion_tokens"] for r in res],
            "fork": {k: m1["fork"][k] - m0["fork"][k] for k in m1["fork"]},
            "refs": refs}
    return out


def pipeline_phase(lm, card: str, config: str) -> dict:
    """Phase 3f on the loaded model (module doc): the pipelined loop (the
    defaults: pipeline_depth 2, the split fused tick) against the
    synchronous one (pipeline_depth 1, prefill_packed_fuse "0"), each on
    an engine of its own over the same weights, one after the other: (a)
    the byte gate, (b) mixed traffic under torch.profiler, and on the
    pipelined engine (c) in-flight prefill dedup."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import Engine

    tag = f"[pipeline {config}]"
    eos = lm.tokenizer.eos_token_id
    vocab = LLAMA31_8B["vocab_size"]
    gen = np.random.default_rng(SEED + 13)
    gate_specs = [(gen.integers(1000, vocab, n).tolist(), k, forced)
                  for n, k, forced in PIPE_GATE]
    runs = {}
    for way, knobs in (("sync", PIPE_SYNC), ("pipe", {})):
        eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                     dataclasses.replace(lm.engine.ecfg, **knobs), device=DEV).start()
        try:
            t0 = time.monotonic()
            m0 = eng.metrics()
            gate = run_together(eng, pipe_requests(gate_specs, eos), f"{tag} {way}")
            m1 = idle_metrics(eng, f"{tag} {way}")
            r = {"gate": gate, "gate_s": time.monotonic() - t0,
                 "gate_pipeline": m1["pipeline"],
                 "gate_packs": m1["packed_prefill"]["dispatches"]
                 - m0["packed_prefill"]["dispatches"]}
            t1 = time.monotonic()
            r["mixed"] = mixed_run(eng, np.random.default_rng(SEED + 17),
                                   f"{tag} {way} mixed")
            t2 = time.monotonic()
            if way == "pipe":
                r["dedup"] = dedup_run(eng, np.random.default_rng(SEED + 19),
                                       f"{tag} dedup")
            log(f"[time] {config}: pipeline_phase {way}: gate {t1 - t0:.1f} s, "
                f"mixed {t2 - t1:.1f} s, dedup {time.monotonic() - t2:.1f} s")
            runs[way] = r
        finally:
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    sync, pipe = runs["sync"], runs["pipe"]
    # (a) identical greedy tokens, request by request; every request ends
    # as it must; two bursts were in flight at the defaults, one at depth 1
    for way in ("sync", "pipe"):
        for (n, k, forced), r in zip(PIPE_GATE, runs[way]["gate"]):
            want = ("stop", 1) if forced else ("length", k)
            if (r["finish"], r["completion_tokens"]) != want:
                raise AssertionError(f"{tag} {way}: a {n}-token request ended "
                                     f"{r['finish']!r} after {r['completion_tokens']} "
                                     f"tokens, expected {want}")
    same = [a["ids"] == b["ids"] for a, b in zip(sync["gate"], pipe["gate"])]
    if not all(same):
        raise AssertionError(f"{tag} greedy tokens differ between depth 1 / \"0\" "
                             f"and the defaults, request by request: {same}")
    if (pipe["gate_pipeline"]["max_inflight"] != 2
            or sync["gate_pipeline"]["max_inflight"] != 1):
        raise AssertionError(f"{tag} bursts in flight: defaults "
                             f"{pipe['gate_pipeline']}, depth 1 {sync['gate_pipeline']}")
    log(f"{tag} {card}: (a) {len(PIPE_GATE)} requests queued together (prompts "
        f"{[n for n, _k, _f in PIPE_GATE]} tokens, max_tokens "
        f"{[k for _n, k, _f in PIPE_GATE]}, 2 stopped on EOS by logit_bias): greedy "
        f"tokens identical request by request at depth 1 / \"0\" and at the "
        f"defaults; {sync['gate_packs']} vs {pipe['gate_packs']} packs; wall "
        f"{sync['gate_s']:.2f} vs {pipe['gate_s']:.2f} s (host clock); defaults' "
        f"loop {json.dumps(pipe['gate_pipeline'])}; no page in use at idle")
    for way in ("sync", "pipe"):
        mx = runs[way]["mixed"]
        tr = mx["trace"]
        log(f"{tag} {card}: (b) {way}: {MIX_ARRIVALS} x {MIX_PROMPT}-token arrivals "
            f"{MIX_SPACING_S * 1e3:.0f} ms apart over {MIX_LONG} decoding requests: "
            f"arrivals' TTFT {', '.join(f'{t:.1f}' for t in mx['ttft_ms'])} ms (host "
            f"clock, submit to first token); "
            + (f"device busy {tr['device_busy_ms']:.1f} ms = "
               f"{tr['span_busy_share'] * 100:.1f}% of the {tr['span_ms']:.1f} ms "
               f"from the first to the last device activity "
               f"({tr['busy_share'] * 100:.1f}% of the {tr['window_ms']:.1f} ms "
               f"traced window: {tr['lead_in_ms']:.1f} ms lead-in, "
               f"{tr['tail_ms']:.1f} ms tail); idle gaps over 20 us by the work "
               f"on their sides {json.dumps(tr['gaps_over_20us'])}" if tr else
               "the profiler recorded no device activity (not measured)")
            + f"; the tracer's decomp_ms over the same window "
              f"{json.dumps(mx['decomp_ms'])}"
            + f"; completion_tokens == max_tokens for all; loop "
              f"{json.dumps(mx['pipeline'])}")
    # (c)
    dd, ctl = pipe["dedup"]["dedup"], pipe["dedup"]["control"]
    want_tokens = DEDUP_PROMPT + DEDUP_N - 1
    if (dd["pack_tokens"] != want_tokens
            or sorted(dd["reused"]) != [0] + [DEDUP_PROMPT - 1] * (DEDUP_N - 1)):
        raise AssertionError(f"{tag} dedup: pack tokens {dd['pack_tokens']} "
                             f"(expected {want_tokens}), reused rows {dd['reused']} "
                             f"(expected one 0, the rest {DEDUP_PROMPT - 1})")
    if ctl["pack_tokens"] != DEDUP_N * DEDUP_PROMPT or any(ctl["reused"]):
        raise AssertionError(f"{tag} control: pack tokens {ctl['pack_tokens']}, "
                             f"reused rows {ctl['reused']}")
    if dd["fork"]["forked"] != DEDUP_N - 1 or not dd["refs"] or min(dd["refs"]) < 2:
        raise AssertionError(f"{tag} dedup: fork {dd['fork']}, references on the "
                             f"leader's prompt pages after the fork {dd['refs']}")
    lead = dd["reused"].index(0)
    ref = dd["logits"][lead]
    sibs = [i for i in range(DEDUP_N) if i != lead]
    same_ids = sum(dd["ids"][i] == dd["ids"][lead] for i in sibs)
    errs = [float((dd["logits"][i] - ref).norm() / ref.norm()) for i in sibs]
    bad = [(i, e) for i, e in zip(sibs, errs)
           if dd["ids"][i] != dd["ids"][lead] and not e <= PREFIX_LOGITS_RTOL]
    if bad or not all(bool(torch.isfinite(x).all()) for x in dd["logits"]):
        raise AssertionError(f"{tag} dedup: siblings whose tokens differ from the "
                             f"leader's and whose first-token logits lie beyond "
                             f"{PREFIX_LOGITS_RTOL} relative L2: {bad}")
    log(f"{tag} {card}: (c) {DEDUP_N} identical {DEDUP_PROMPT}-token greedy "
        f"requests: {dd['pack_tokens']} pack tokens in {dd['packs']} packs, reused "
        f"rows {dd['reused']}, fork {json.dumps(dd['fork'])}, fewest references on "
        f"the leader's prompt pages after the fork {min(dd['refs'])}; "
        f"{same_ids} of {DEDUP_N - 1} siblings' tokens equal the leader's, their "
        f"first-token logits vs the leader's relative L2 "
        f"{', '.join(f'{e:.3e}' for e in errs)} (tol {PREFIX_LOGITS_RTOL}); TTFT "
        f"{', '.join(f'{t:.1f}' for t in dd['ttft_ms'])} ms, packs' device time "
        f"{dd['prefill_device_ms']:.2f} ms; control (last token differs): "
        f"{ctl['pack_tokens']} pack tokens in {ctl['packs']} packs, TTFT "
        f"{', '.join(f'{t:.1f}' for t in ctl['ttft_ms'])} ms, packs' device time "
        f"{ctl['prefill_device_ms']:.2f} ms")
    out = {way: {"gate_s": r["gate_s"], "gate_packs": r["gate_packs"],
                 "gate_pipeline": r["gate_pipeline"], "mixed": r["mixed"]}
           for way, r in runs.items()}
    out["gate_identical"] = sum(same)
    out["dedup"] = {name: {k: v for k, v in g.items() if k not in ("ids", "logits")}
                    for name, g in pipe["dedup"].items()}
    out["dedup"]["siblings_same_tokens"] = same_ids
    out["dedup"]["sibling_logits_rel_l2"] = errs
    out["race"] = race_counts(lm, config, kv_offload=False)
    return out


# ---------- phase 3h: the request lifecycle ----------

LC_QUEUE = 4                    # (a) max_queued_requests
LC_HOLD = (32, 400)             # (a), (e) the 8 requests holding the slots
LC_BURST = 12                   # (a) requests sent at once
LC_LOW = (600, 300)             # (b), (c) the low requests
LC_ARRIVAL = (1500, 64)         # (b), (c) the arrival / the high requests
LC_POOL = 96                    # (c) pages
LC_STALL_MS = 300               # (d) dispatch_stall_ms
LC_TIMEOUT = (200, 2000)        # (e) request_timeout_ms, max_tokens
LC_QWAIT_MS = 100               # (e) max_queue_wait_ms


def http_any(url: str, body: dict, timeout=600, cid: str = ""):
    """(status, headers, body) of a POST, error statuses included: the
    JSON object, or for a stream answered 200 its SSE chunks."""
    import urllib.error

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=http_headers(cid))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, raw = r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, dict(e.headers), e.read().decode()
    if body.get("stream") and status == 200:
        return status, headers, [json.loads(ln[6:]) for ln in raw.splitlines()
                                 if ln.startswith("data: ") and ln[6:] != "[DONE]"]
    return status, headers, json.loads(raw)


def lc_reader(out):
    """A thread filling a dict with a stream's ids, its last event, its
    first event's time and its error."""
    res = {"ids": [], "last": None, "t_first": None, "error": None}

    def read():
        while (ev := out.get(timeout=900)) is not None:
            res["t_first"] = res["t_first"] or time.monotonic()
            res["ids"].extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
            res["last"] = ev
            res["error"] = res["error"] or ev.error
        res["done"] = True

    th = threading.Thread(target=read, daemon=True)
    th.start()
    return res, th


def lc_hold(eng, reqs, tag):
    """Submit ``reqs`` past the queue bound (lifted meanwhile: the knob is
    read at each submit) and wait until they all run."""
    maxq, eng.ecfg.max_queued_requests = eng.ecfg.max_queued_requests, 0
    try:
        outs = [eng.submit(r) for r in reqs]
    finally:
        eng.ecfg.max_queued_requests = maxq
    lc_wait(lambda: eng.num_active == len(reqs) and eng._queue.empty(), tag,
            f"{len(reqs)} running")
    return outs


def lc_wait(cond, tag, what, timeout=300):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"{tag} timed out waiting for {what}")
        time.sleep(0.002)


def stall_once(eng):
    """Make the engine's next burst late on the card: a GPU sleep of about
    1 s enqueued on its stream just ahead of the burst (engine thread), so
    the burst's event fires that much later. A hook of this script only."""
    import torch

    burst = eng._burst

    def late(n_steps, active):
        del eng._burst
        torch.cuda._sleep(int(torch.cuda.get_device_properties(0).clock_rate * 1e3))
        return burst(n_steps, active)

    eng._burst = late


def lc_shed(eng, url, greedy, prompt, tag):
    """(a) 8 decodes hold the slots; LC_BURST requests arrive at once
    (half streamed): LC_QUEUE queue, the rest are answered 429."""
    m0 = eng.metrics()["lifecycle"]
    holds = [greedy(prompt(LC_HOLD[0]), LC_HOLD[1]) for _ in range(8)]
    outs = lc_hold(eng, holds, tag)
    shed_us, shed = [], eng._shed

    def spy(req, reason):
        shed(req, reason)
        shed_us.append((time.monotonic() - req.t_submit) * 1e6)

    eng._shed = spy
    res = [None] * LC_BURST

    def post(i):
        t0 = time.monotonic()
        st, h, _b = http_any(url, {"messages": [{"role": "user", "content": f"q {i}"}],
                                   "max_tokens": 8, "temperature": 0,
                                   "ignore_eos": True, "stream": i % 2 == 1})
        res[i] = (st, h.get("Retry-After"), (time.monotonic() - t0) * 1e3)

    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(LC_BURST)]
    try:
        for t in threads:
            t.start()
        lc_wait(lambda: len(shed_us) >= LC_BURST - LC_QUEUE, tag, "the sheds", 60)
        queued = eng.metrics()["queued"]
    finally:
        del eng._shed
        for r in holds:
            eng.cancel(r.request_id)
    for t in threads:
        t.join(timeout=300)
    for o in outs:
        while o.get(timeout=300) is not None:
            pass
    statuses = sorted(r[0] for r in res if r)
    n_shed = eng.metrics()["lifecycle"]["requests_shed"] - m0["requests_shed"]
    want = [200] * LC_QUEUE + [429] * (LC_BURST - LC_QUEUE)
    bad_ra = [r for r in res if r and r[0] == 429 and not (r[1] and int(r[1]) >= 1)]
    if statuses != want or queued != LC_QUEUE or n_shed != len(want) - LC_QUEUE or bad_ra:
        raise AssertionError(f"{tag} (a) statuses {statuses}, {queued} queued, "
                             f"{n_shed} shed, 429s without Retry-After {bad_ra}")
    ms429 = sorted(r[2] for r in res if r[0] == 429)
    return {"queued": queued, "shed": n_shed, "shed_us": sorted(shed_us),
            "http_429_ms": ms429}


def lc_priority(eng, chat, greedy, prompt, text, tag):
    """(b) 8 low requests fill the slots; a 1500-token arrival at high,
    normal (both outrank low: they preempt) and low (it waits), each on a
    fresh round of the same low requests (low first: the unpreempted
    reference)."""
    import torch

    low_prompts = [prompt(LC_LOW[0]) for _ in range(8)]
    arrival = text(LC_ARRIVAL[0])
    rounds = {}
    for cls in ("low", "high", "normal"):
        on_engine_thread(eng, lambda: forget_retained(eng))
        m0 = eng.metrics()["scheduler"]
        pauses, resumes, emits = [], [], {}
        pre, start_resume, emit = eng._preempt_slot, eng._start_resume, eng._emit

        def spy_pre(slot, why="priority"):
            s = eng.slots[slot]
            pauses.append({"rid": s.req.request_id, "n_decoded": s.n_decoded,
                           "committed": s.committed, "t": time.monotonic()})
            return pre(slot, why)

        def spy_resume(entry):
            slot = start_resume(entry)
            resumes.append({"rid": entry.req.request_id, "slot": slot,
                            "reused": eng.slots[slot].reused,
                            "history": len(entry.ids), "t": time.monotonic(),
                            "parked_ms": (time.monotonic() - entry.t_parked) * 1e3})
            emits[slot] = None
            return slot

        def spy_emit(slot, token_id, logprob):
            if slot in emits and emits[slot] is None:
                emits[slot] = time.monotonic()
            return emit(slot, token_id, logprob)

        eng._preempt_slot, eng._start_resume, eng._emit = spy_pre, spy_resume, spy_emit
        try:
            reqs = [greedy(p, LC_LOW[1], "low") for p in low_prompts]
            gate = threading.Event()
            admit = eng._admit
            eng._admit = lambda admit=admit: gate.is_set() and admit()
            maxq, eng.ecfg.max_queued_requests = eng.ecfg.max_queued_requests, 0
            readers = [lc_reader(eng.submit(r)) for r in reqs]
            eng.ecfg.max_queued_requests = maxq
            gate.set()
            del eng._admit
            eng._wake.set()
            lc_wait(lambda: all(r[0]["t_first"] for r in readers), tag, "8 lows")
            t0 = time.monotonic()
            chunks, t_first, _t = http_stream(chat, {
                "messages": [{"role": "user", "content": arrival}],
                "max_tokens": LC_ARRIVAL[1], "temperature": 0,
                "ignore_eos": True, "stream": True, "priority": cls})
            ttft_ms = (t_first - t0) * 1e3     # the role chunk: the first token
            for _r, th in readers:
                th.join(timeout=900)
            torch.cuda.synchronize()
        finally:
            del eng._preempt_slot, eng._start_resume, eng._emit
        bad = [(i, r["error"], len(r["ids"])) for i, (r, _t) in enumerate(readers)
               if r["error"] or len(r["ids"]) != LC_LOW[1]
               or r["last"].completion_tokens != LC_LOW[1]]
        got = chunks[-1]["usage"]["completion_tokens"]
        m1 = eng.metrics()["scheduler"]
        n_pre = m1["preemptions"] - m0["preemptions"]
        # a low arrival waits for a slot (it may age past
        # priority_aging_ms and preempt; printed, not required)
        if bad or got != LC_ARRIVAL[1] or (n_pre == 0 and cls != "low"):
            raise AssertionError(f"{tag} (b) {cls}: lows {bad}, arrival {got} tokens, "
                                 f"{n_pre} preemptions")
        rids = [r.request_id for r in reqs]
        victims = []
        for p in pauses:
            i = rids.index(p["rid"])
            rs = next(x for x in resumes if x["rid"] == p["rid"])
            # the device-tier splice gives back every committed full page
            want = min((p["committed"] // PG) * PG, rs["history"] - 1)
            if rs["reused"] != want:
                raise AssertionError(f"{tag} (b) {cls}: the resume reused "
                                     f"{rs['reused']} rows, {want} committed")
            ref = rounds.get("low", {}).get("ids", [None] * 8)[i]
            victims.append({
                "request": i, "paused_at_token": p["n_decoded"],
                "pause_to_resume_ms": (rs["t"] - p["t"]) * 1e3,
                "parked_ms": rs["parked_ms"], "reused_rows": rs["reused"],
                "committed_rows": p["committed"],
                "resume_to_token_ms": (emits[rs["slot"]] - rs["t"]) * 1e3,
                "tokens": len(readers[i][0]["ids"]),
                "match_unpreempted": None if ref is None else sum(
                    a == b for a, b in zip(readers[i][0]["ids"], ref)),
                "prefix_match": None if ref is None else next(
                    (k for k, (a, b) in enumerate(zip(readers[i][0]["ids"], ref))
                     if a != b), len(ref))})
        rounds[cls] = {"ttft_ms": ttft_ms, "preemptions": n_pre,
                       "resumes": m1["resumes"] - m0["resumes"],
                       "victims": victims,
                       "ids": [r["ids"] for r, _t in readers]}
    for r in rounds.values():
        del r["ids"]
    return rounds


def lc_deadlines(eng, url, greedy, prompt, tag):
    """(e) a request past request_timeout_ms mid-decode: 504, its slot and
    pages released; a request queued past max_queue_wait_ms: 429."""
    body = {"messages": [{"role": "user", "content": "a long answer"}],
            "temperature": 0, "ignore_eos": True}
    eng.ecfg.request_timeout_ms = LC_TIMEOUT[0]
    t0 = time.monotonic()
    try:
        st, _h, err = http_any(url, {**body, "max_tokens": LC_TIMEOUT[1]})
    finally:
        eng.ecfg.request_timeout_ms = 0
    t504 = (time.monotonic() - t0) * 1e3
    m = idle_metrics(eng, tag)
    if st != 504 or err["error"]["type"] != "deadline_exceeded":
        raise AssertionError(f"{tag} (e) request_timeout_ms: {st} {err}")
    holds = [greedy(prompt(LC_HOLD[0]), LC_HOLD[1]) for _ in range(8)]
    outs = lc_hold(eng, holds, tag)
    eng.ecfg.max_queue_wait_ms = LC_QWAIT_MS
    t0 = time.monotonic()
    try:
        st2, h2, err2 = http_any(url, {**body, "max_tokens": 8})
    finally:
        eng.ecfg.max_queue_wait_ms = 0
        for r in holds:
            eng.cancel(r.request_id)
    t429 = (time.monotonic() - t0) * 1e3
    for o in outs:
        while o.get(timeout=300) is not None:
            pass
    idle_metrics(eng, tag)
    if st2 != 429 or "max_queue_wait_ms" not in err2["error"]["message"]:
        raise AssertionError(f"{tag} (e) max_queue_wait_ms: {st2} {err2}")
    return {"timeout_http_ms": t504, "timeout_pages_in_use": m["pages_in_use"],
            "queue_wait_http_ms": t429, "retry_after": h2.get("Retry-After")}


def lc_stall(lm, eng, url, greedy, prompt, tag):
    """(d) a real device stall under dispatch_stall_ms = LC_STALL_MS: the
    stalled burst's request gets a 503; a request sent after the sleep has
    run is served, with the greedy tokens of the loaded engine (the same
    configuration) on the same prompt. Phase 3j (c): every stall wrote a
    span-ring dump (``lifecycle.stall_dumps`` == ``stalls``: at depth 2
    the burst queued behind the sleep stalls too, with no request left);
    the first loads as Chrome trace JSON and holds the stalled request's
    spans and its burst's dispatch; one flight dump (rate-limited) names
    the request."""
    import glob

    probe = prompt(40)
    dump_dir = os.path.join(ROOT, "build", "chip_smoke", "stall_dumps",
                            tag.strip("[]").replace(" ", "-"))
    for f in glob.glob(os.path.join(dump_dir, "localai-*")):
        os.unlink(f)
    eng.ecfg.stall_dump_dir = eng._flight.out_dir = dump_dir
    cid = f"stall-{tag.strip('[]').replace(' ', '-')}"

    def ids_of(events):
        return [t for e in events for t in (e.token_ids or [e.token_id])]

    on_engine_thread(lm.engine, lambda: forget_retained(lm.engine))
    want = ids_of(lm.engine.generate(greedy(probe, 32)))
    aborts, handle = [], eng._handle_stall

    def spy(item):
        aborts.append((time.monotonic() - item.t0) * 1e3)
        return handle(item)

    eng.ecfg.dispatch_stall_ms = LC_STALL_MS
    eng._handle_stall = spy
    try:
        stall_once(eng)
        st, h, err = http_any(url, {"messages": [{"role": "user", "content": "stall"}],
                                    "max_tokens": 64, "temperature": 0,
                                    "ignore_eos": True}, cid=cid)
        time.sleep(1.5)                     # the GPU sleep has run
    finally:
        eng.ecfg.dispatch_stall_ms = 30000
        del eng._handle_stall
        eng.__dict__.pop("_burst", None)
    on_engine_thread(eng, lambda: forget_retained(eng))
    evs = list(eng.generate(greedy(probe, 32)))
    got = ids_of(evs)
    m = idle_metrics(eng, tag)
    if (st != 503 or err["error"]["type"] != "backend_unavailable" or not aborts
            or any(e.error for e in evs) or got != want):
        raise AssertionError(f"{tag} (d) {st} {err}; aborts {aborts}; after the "
                             f"stall {[e.error for e in evs if e.error]}, tokens "
                             f"equal: {got == want}")
    # the dumps' names end in their wall-clock ms: the first is the stall's
    rings = sorted(glob.glob(os.path.join(dump_dir, "localai-stall-*.trace.json")))
    flights = glob.glob(os.path.join(dump_dir, "localai-flight-stall-*.json"))
    ring = {}
    if rings:
        with open(rings[0]) as f:
            ring = json.load(f)
    xs = [ev for ev in ring.get("traceEvents", ()) if ev.get("ph") == "X"]
    mine = {ev["name"]: ev["ts"] for ev in xs
            if ev["args"].get("request_id") == cid}
    # the stalled burst's dispatch: a plain burst's decode_dispatch, or the
    # fused tick's prefill_dispatch, after the request's admission
    burst = [ev["name"] for ev in xs
             if ev["name"] in ("decode_dispatch", "prefill_dispatch")
             and ev["ts"] >= mine.get("admission", float("inf"))]
    flight = {}
    if len(flights) == 1:
        with open(flights[0]) as f:
            flight = json.load(f)
    lc = m["lifecycle"]
    if (not 1 <= lc["stall_dumps"] == lc["stalls"] == len(rings)
            or not {"queue_wait", "admission"} <= set(mine) or not burst
            or flight.get("requests") != [cid]
            or not {"trace", "state", "events"} <= set(flight)):
        raise AssertionError(f"{tag} (d) stall dumps: {m['lifecycle']}, rings "
                             f"{rings}, spans of {cid} {sorted(mine)}, flights "
                             f"{flights} {sorted(flight)[:8]}")
    log(f"{tag} (d) 3j (c): the span-ring dump {os.path.basename(rings[0])} loads "
        f"as Chrome trace JSON: {len(xs)} spans, {cid}'s {sorted(mine)} and the "
        f"stalled burst's {burst[-1]}; flight dump "
        f"{os.path.basename(flights[0])} names {flight['requests']}; "
        f"lifecycle stalls {lc['stalls']}, stall_dumps {lc['stall_dumps']}")
    return {"dispatch_to_abort_ms": aborts, "http_status": st,
            "ring_dump_spans": len(xs), "stall_dumps": lc["stall_dumps"],
            "retry_after": h.get("Retry-After"), "stalls": m["lifecycle"]["stalls"],
            "after_tokens_equal": True}


def lc_pressure(lm, greedy, prompt, tag):
    """(c) a 96-page pool: 6 low requests decode, then 2 high ones arrive;
    every request completes."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine

    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                 dataclasses.replace(lm.engine.ecfg, kv_pool_pages=LC_POOL),
                 device=DEV).start()
    try:
        lows = [greedy(prompt(LC_LOW[0]), LC_LOW[1], "low") for _ in range(6)]
        highs = [greedy(prompt(LC_ARRIVAL[0]), LC_ARRIVAL[1], "high") for _ in range(2)]
        t0 = time.monotonic()
        readers = [lc_reader(eng.submit(r)) for r in lows]
        lc_wait(lambda: all(r[0]["t_first"] for r in readers), tag, "6 lows")
        readers += [lc_reader(eng.submit(r)) for r in highs]
        for _r, th in readers:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        m = idle_metrics(eng, tag)
        bad = [(i, r["error"], len(r["ids"])) for i, (r, _t) in enumerate(readers)
               if r["error"] or len(r["ids"]) != (LC_LOW[1] if i < 6 else LC_ARRIVAL[1])]
        if bad or m["scheduler"]["preemptions"] < 1:
            raise AssertionError(f"{tag} (c) failed requests {bad}; "
                                 f"{m['scheduler']['preemptions']} preemptions")
        sch = m["scheduler"]
        return {"wall_s": wall, "completed": len(readers),
                **{k: sch[k] for k in ("preemptions", "resumes", "resume_reprefills",
                                       "resume_restore_rows")},
                "restored_pages": m.get("kv_offload", {}).get("restored_pages"),
                "evicted_pages": m.get("prefix_cache", {}).get("evicted_pages")}
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def lifecycle_phase(lm, card: str, config: str) -> dict:
    """Phase 3h on the loaded model (module doc): (a) shed, (b) priority
    preemption, (e) deadlines and (d) the stall watchdog on one engine with
    max_queued_requests 4 behind the HTTP server, then (c) pool-pressure
    preemption on a 96-page engine."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    tag = f"[lifecycle {config}]"
    vocab = LLAMA31_8B["vocab_size"]
    gen = np.random.default_rng(SEED + 23)

    def prompt(n):
        return gen.integers(1000, vocab, n).tolist()

    def text(n):
        return "".join(chr(c) for c in gen.integers(97, 123, n))

    def greedy(ids, n, priority=""):
        return GenRequest(prompt_ids=list(ids), max_new_tokens=n, ignore_eos=True,
                          priority=priority, params=SamplingParamsHost(temperature=0.0))

    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                 dataclasses.replace(lm.engine.ecfg, max_queued_requests=LC_QUEUE),
                 device=DEV).start()
    app = App({lm.name: dataclasses.replace(lm, engine=eng)})
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    chat = base + "/v1/chat/completions"
    out = {}
    try:
        out["shed"] = lc_shed(eng, chat, greedy, prompt, tag)
        out["priority"] = lc_priority(eng, chat, greedy, prompt, text, tag)
        out["deadline"] = lc_deadlines(eng, chat, greedy, prompt, tag)
        out["stall"] = lc_stall(lm, eng, chat, greedy, prompt, tag)
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
        del eng, app
        gc.collect()
        torch.cuda.empty_cache()
    out["pressure"] = lc_pressure(lm, greedy, prompt, tag)
    sh, pr, dl, st, pp = (out[k] for k in ("shed", "priority", "deadline", "stall",
                                           "pressure"))
    log(f"{tag} {card}: (a) {sh['shed']} of {LC_BURST} shed, {sh['queued']} queued; "
        f"submit -> shed event {sh['shed_us'][len(sh['shed_us']) // 2]:.1f} us median "
        f"(max {sh['shed_us'][-1]:.1f}); HTTP 429 in "
        f"{sh['http_429_ms'][len(sh['http_429_ms']) // 2]:.2f} ms median")
    for cls, r in pr.items():
        v = r["victims"][0] if r["victims"] else None
        log(f"{tag} {card}: (b) {LC_ARRIVAL[0]}-token arrival at {cls}: TTFT "
            f"{r['ttft_ms']:.1f} ms, {r['preemptions']} preemptions"
            + (f"; victim paused at token {v['paused_at_token']}, pause -> resume "
               f"{v['pause_to_resume_ms']:.1f} ms, reused {v['reused_rows']} rows "
               f"({v['committed_rows']} committed), resume -> next token "
               f"{v['resume_to_token_ms']:.2f} ms, {v['tokens']} tokens, "
               f"{v['match_unpreempted']} equal to the unpreempted run's "
               f"(first {v['prefix_match']} in a row)" if v else ""))
    log(f"{tag} {card}: (c) {LC_POOL}-page pool, 6 low + 2 high: all "
        f"{pp['completed']} completed in {pp['wall_s']:.2f} s; {pp['preemptions']} "
        f"preemptions, {pp['resumes']} resumes, {pp['resume_reprefills']} "
        f"re-prefills, {pp['resume_restore_rows']} rows restored at resume, "
        f"{pp['restored_pages']} pages restored from the host tier")
    log(f"{tag} {card}: (d) stall at {LC_STALL_MS} ms: dispatch -> abort "
        f"{', '.join(f'{a:.1f}' for a in st['dispatch_to_abort_ms'])} ms, HTTP "
        f"{st['http_status']} (Retry-After {st['retry_after']}); the next request's "
        f"tokens equal the loaded engine's")
    log(f"{tag} {card}: (e) request_timeout_ms {LC_TIMEOUT[0]}: HTTP 504 after "
        f"{dl['timeout_http_ms']:.1f} ms, {dl['timeout_pages_in_use']} pages in use "
        f"after; max_queue_wait_ms {LC_QWAIT_MS}: HTTP 429 after "
        f"{dl['queue_wait_http_ms']:.1f} ms")
    return out


# ---------- phase 3i: n-gram self-speculation ----------

# max_tokens of each of the 8 requests (3i, and 3k on 3i's sets): 128,
# so the whole script stays inside its 1200-second limit with phase 3n and
# the race arrangements
SPEC_TOKENS = 128
SPEC_PHRASE = "The cat sat on the mat. "
SPEC_KEYS = ("dispatches", "mixed_dispatches", "rounds", "proposed", "accepted",
             "tokens")
SPEC_TRACED_TICK = 3         # which spec tick of the repetitive run is traced
SPEC_PART_ROWS = 1024        # committed rows of each slot in the round's split


def pin_speculation(eng, on: bool):
    """Speculation on (draft "auto", the default: the draft model when the
    engine has one, else n-gram) or off ("0", the mode it resolves to) for
    what an idle engine admits next, and in the config later engines copy
    (dataclasses.replace(eng.ecfg, ...))."""
    eng.ecfg.draft = "auto" if on else "0"
    eng._spec_mode = (("model" if eng.draft_params is not None else "ngram")
                      if on else "off")


def spec_tiny_phase(card: str) -> dict:
    """(a) On the card, a small f32 model (head_dim 128): greedy tokens with
    speculation byte-identical to draft "0" on paged, int8 KV and
    contiguous engines; the captured round against its eager form
    (DecodeGraph.spec_eager) on the same chained state: tokens and n_out
    identical, logprobs within 1e-4."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.models import llama

    class Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    cfg = llama.LlamaConfig(vocab_size=96, hidden_size=512, intermediate_size=1024,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                            rope_theta=500000.0, dtype=torch.float32)
    params = random_params(cfg, SEED, device=DEV)
    base = EngineConfig(num_slots=4, max_context=256, prefill_chunk=32,
                        kv_page_size=16, decode_burst=16, kv_offload=False)
    prompts = [[5, 6, 7, 8] * 8, list(range(10, 50)), [9, 9, 3] * 7, list(range(60, 71))]
    out = {}
    for kind, knobs in (("paged", {}), ("int8", {"cache_dtype": torch.int8}),
                        ("contig", {"kv_layout": "contiguous"})):
        streams = {}
        # one engine, speculation on then off (the mode draft "0"
        # resolves to), nothing retained between the two runs
        e = Engine(cfg, params, Tok(), dataclasses.replace(base, **knobs),
                   device=DEV).start()
        try:
            for draft in ("auto", "0"):
                pin_speculation(e, draft == "auto")
                on_engine_thread(e, lambda e=e: forget_retained(e))
                outs = [e.submit(GenRequest(prompt_ids=list(p), max_new_tokens=60,
                                            ignore_eos=True,
                                            params=SamplingParamsHost(temperature=0.0)))
                        for p in prompts]
                ids = []
                for o in outs:
                    got = []
                    while (ev := o.get(timeout=600)) is not None:
                        if ev.error:
                            raise AssertionError(f"[spec tiny {kind}] {ev.error}")
                        got.extend(ev.token_ids or [ev.token_id])
                    ids.append(got)
                streams[draft] = (ids, dict(e.metrics()["spec"]))
                if draft == "auto":
                    err = on_engine_thread(e, lambda e=e: spec_graph_vs_eager(e))
                    err_s = on_engine_thread(
                        e, lambda e=e: spec_graph_vs_eager(e, sampled=True))
            if kind == "paged":
                chi = sampled_chi2(e, GenRequest, SamplingParamsHost, prompts)
        finally:
            e.shutdown()
        (sid, st), (pid, pst) = streams["auto"], streams["0"]
        if pst["rounds"] != st["rounds"]:
            raise AssertionError(f"[spec tiny {kind}] spec rounds ran with "
                                 f"speculation off: {pst} after {st}")
        if sid != pid:
            raise AssertionError(f"[spec tiny {kind}] greedy tokens with speculation "
                                 f"differ from draft=0: {sid} vs {pid}")
        if st["rounds"] <= 0:
            raise AssertionError(f"[spec tiny {kind}] no spec round ran: {st}")
        out[kind] = {"rounds": st["rounds"], "accepted": st["accepted"],
                     "graph_vs_eager_logprob_err": err,
                     "sampled_graph_vs_eager_logprob_err": err_s}
        log(f"[spec tiny {kind}] {card}: f32 greedy tokens with speculation == "
            f"draft=0 ({len(prompts)} x 60); {st['rounds']} rounds, "
            f"{st['accepted']} of {st['proposed']} proposals accepted; captured "
            f"round == eager form (tokens, n_out), logprob max err {err:.2e} "
            f"greedy, {err_s:.2e} sampled")
    out["sampled_chi2"] = chi
    log(f"[spec tiny paged] {card}: {SPEC_CHI_SEEDS} seeded sampled requests x "
        f"{SPEC_CHI_TOKENS} tokens, speculation vs draft=0: chi2 {chi['stat']:.2f}, "
        f"dof {chi['dof']}, p {chi['p']:.4f}; {chi['rounds']} sampled rounds, "
        f"acceptance {chi['acceptance_rate']:.3f}")
    return out


SPEC_CHI_SEEDS, SPEC_CHI_TOKENS = 16, 48


def sampled_chi2(e, GenRequest, SamplingParamsHost, prompts) -> dict:
    """SPEC_CHI_SEEDS seeded sampled requests (temperature 0.8, top_k 16)
    x SPEC_CHI_TOKENS tokens, queued together, with speculation and with
    draft "0": the token counts' two-sample chi-square (one law, so p >
    0.01; fixed seeds, so the run is deterministic)."""
    import numpy as np

    from localai_tpu_torch.engine.speculative import two_sample_chi2

    V = e.cfg.vocab_size
    counts, stats = {}, {}
    for draft in ("auto", "0"):
        pin_speculation(e, draft == "auto")
        on_engine_thread(e, lambda: forget_retained(e))
        m0 = e.metrics()["spec"]["by_mode"]["sampled"]
        c = np.zeros(V, np.int64)
        # queued together, served 4 at a time: a seeded stream's law does
        # not depend on its neighbours
        outs = [e.submit(GenRequest(
            prompt_ids=list(prompts[i % len(prompts)]),
            max_new_tokens=SPEC_CHI_TOKENS, ignore_eos=True,
            params=SamplingParamsHost(temperature=0.8, top_k=16, seed=SEED + i)))
            for i in range(SPEC_CHI_SEEDS)]
        for out in outs:
            ids = []
            while (ev := out.get(timeout=600)) is not None:
                if ev.error:
                    raise AssertionError(f"[spec tiny chi2] {ev.error}")
                ids.extend(ev.token_ids or [ev.token_id])
            if len(ids) != SPEC_CHI_TOKENS:
                raise AssertionError(f"[spec tiny chi2] {len(ids)} tokens")
            c += np.bincount(ids, minlength=V)[:V]
        m1 = e.metrics()["spec"]["by_mode"]["sampled"]
        counts[draft] = c
        stats[draft] = {k: m1[k] - m0[k] for k in ("rounds", "proposed", "accepted")}
    pin_speculation(e, True)
    stat, dof, p = two_sample_chi2(counts["auto"], counts["0"])
    st = stats["auto"]
    if st["rounds"] <= 0 or stats["0"]["rounds"] != 0:
        raise AssertionError(f"[spec tiny chi2] sampled rounds: {stats}")
    if not (dof >= 1 and p > 0.01):
        raise AssertionError(f"[spec tiny chi2] sampled speculation moves the law: "
                             f"chi2 {stat:.2f}, dof {dof}, p {p:.4g}")
    return {"stat": stat, "dof": dof, "p": p, "rounds": st["rounds"],
            "acceptance_rate": st["accepted"] / max(1, st["proposed"])}


def spec_graph_vs_eager(e, sampled: bool = False) -> float:
    """On an idle engine's thread: 3 slots decoding 2 rounds from the same
    state through the captured round and through the eager form, the
    state restored in between; two of them speculate. With ``sampled``
    the three draw (seeded, temperature 0.8: rejection-sampled acceptance
    on the spec rows, counters included). Returns the logprobs' max abs
    error."""
    import numpy as np
    import torch

    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    g = e._graph
    samp = e.sampler
    S = g.tokens.shape[0]
    for s in range(3):
        samp.set_slot(s, SamplingParamsHost(temperature=0.8 if sampled else 0.0,
                                            seed=SEED + s, top_k=0, top_p=1.0), 0)
    forget_retained(e)           # the rows written below are nobody's
    if e._pool is not None:
        for s in range(3):
            e._pool.ensure(s, 64)
    e._commit_ptab()
    rows = np.stack([[1, 1, 1, 0], np.ones(S), [5, 9, 12, 0], [20, 24, 31, 0],
                     [1, 1, 0, 0]]).astype(np.int64)
    for s, h in enumerate(([5, 6, 7, 8] * 5, [9, 3, 9, 3] * 6, list(range(12, 43)))):
        samp.set_ring(s, h)
    saved = [t.clone() for t in (samp.ring, samp.ring_pos, samp.counter, samp.mu)]
    g.load(rows)
    got = g.spec_replay(2).wait()
    for t, v in zip((samp.ring, samp.ring_pos, samp.counter, samp.mu), saved):
        t.copy_(v)
    g.load(rows)
    ref = g.spec_eager(2)
    W = g.spec_width
    if not (np.array_equal(got[:, :W], ref[:, :W])
            and np.array_equal(got[:, 2 * W], ref[:, 2 * W])):
        raise AssertionError(f"spec round graph != eager: {got[:, :W]} vs {ref[:, :W]}")
    err = float(np.abs(got[:, W:2 * W] - ref[:, W:2 * W]).max())
    if err > 1e-4:
        raise AssertionError(f"spec round graph vs eager logprobs err {err:.3e} > 1e-4")
    if sampled and not (samp.counter[:2] >= 2 * W).all():
        raise AssertionError(f"sampled spec rows drew {samp.counter.tolist()}, "
                             f"expected {W} a round")
    for s in range(3):
        if e._pool is not None:
            e._pool.release(s, 0)
        e._cache_tokens[s] = []
    g.load(np.zeros((5, S), np.int64))
    torch.cuda.synchronize()
    return err


def spec_run(lm, eng, prompts, spec: bool, tag: str, trace: bool = False,
             sampled: bool = False) -> dict:
    """8 greedy (``sampled``: seeded, temperature 0.8) requests of
    SPEC_TOKENS tokens, admitted together, with speculation on or off: streams, decode tok/s (tokens after each
    request's first over the time from the last first token to the last
    token, host clock), the ticks' host ms (Engine.metrics decode
    seconds per tick and per round or step), the spec counters; with
    ``trace``, one spec tick with all 8 slots under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    pin_speculation(eng, spec)
    prof_box, ticks = {}, [0]
    tick = eng._spec_tick

    def traced(n_rounds, active, tick=tick):
        ticks[0] += 1
        if trace and not prof_box and ticks[0] >= SPEC_TRACED_TICK \
                and int(active.sum()) == S_SLOTS:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(ANNOTATION):
                    fetch = tick(n_rounds, active)
                    fetch.wait()
            prof_box["prof"], prof_box["rounds"] = prof, n_rounds
            return fetch
        return tick(n_rounds, active)

    gate = threading.Event()
    admit = eng._admit
    fresh = [True]

    def gated(admit=admit):
        if not gate.is_set():
            return False
        if fresh:
            fresh.clear()
            forget_retained(eng)
        return admit()

    eng._admit = gated
    eng._spec_tick = traced
    try:
        m0 = eng.metrics()
        outs = [eng.submit(GenRequest(
            prompt_ids=list(p), max_new_tokens=SPEC_TOKENS, ignore_eos=True,
            params=SamplingParamsHost(temperature=0.8, seed=SEED + i) if sampled
            else SamplingParamsHost(temperature=0.0)))
                for i, p in enumerate(prompts)]
        n = len(outs)
        streams, firsts, lasts, errors = [None] * n, [0.0] * n, [0.0] * n, []

        def read(i):
            ids = []
            while (ev := outs[i].get(timeout=900)) is not None:
                if ev.error:
                    errors.append(ev.error)
                firsts[i] = firsts[i] or time.monotonic()
                ids.extend(ev.token_ids or [ev.token_id])
            lasts[i] = time.monotonic()
            streams[i] = ids

        readers = [threading.Thread(target=read, args=(i,)) for i in range(n)]
        for t in readers:
            t.start()
        gate.set()
        eng._wake.set()
        for t in readers:
            t.join(timeout=900)
        if errors or any(x is None for x in streams):
            raise AssertionError(f"{tag}: {errors or 'a stream did not end'}")
        torch.cuda.synchronize()
        m1 = eng.metrics()
    finally:
        del eng._admit, eng._spec_tick
    if any(len(s) != SPEC_TOKENS for s in streams):
        raise AssertionError(f"{tag}: stream lengths {[len(s) for s in streams]}")
    dec = {k: m1["decode"][k] - m0["decode"][k] for k in m1["decode"]}
    sp = {k: m1["spec"][k] - m0["spec"][k] for k in SPEC_KEYS}
    mode = "sampled" if sampled else "greedy"
    if sp["rounds"] != (m1["spec"]["by_mode"][mode]["rounds"]
                        - m0["spec"]["by_mode"][mode]["rounds"]):
        raise AssertionError(f"{tag}: spec rounds outside by_mode[{mode!r}]: "
                             f"{m1['spec']['by_mode']}")
    wall = max(lasts) - max(firsts)
    r = {"tok_s": S_SLOTS * (SPEC_TOKENS - 1) / max(1e-9, wall),
         "decode_wall_s": wall, "ticks": dec["bursts"],
         "spec_ticks": dec["spec_ticks"], "rounds_or_steps": dec["steps"],
         "ms_per_tick": dec["seconds"] / max(1, dec["bursts"]) * 1e3,
         "ms_per_round_or_step": dec["seconds"] / max(1, dec["steps"]) * 1e3,
         **sp,
         "acceptance_rate": sp["accepted"] / sp["proposed"] if sp["proposed"] else 0.0,
         "accept_per_dispatch": sp["tokens"] / sp["rounds"] if sp["rounds"] else 0.0,
         "streams": streams}
    if spec and sp["rounds"] <= 0:
        raise AssertionError(f"{tag}: no spec round ran: {sp}")
    if not spec and sp["dispatches"] != 0:
        raise AssertionError(f"{tag}: speculation off, yet spec ticks ran: {sp}")
    if trace:
        if not prof_box:
            raise AssertionError(f"{tag}: no spec tick with all {S_SLOTS} slots traced")
        r["trace"] = trace_split(prof_box["prof"], prof_box["rounds"])
        r["traced_rounds"] = prof_box["rounds"]
    return r


def round_parts(eng) -> dict:
    """On an idle engine's thread: the spec round's parts timed alone, each
    captured as a CUDA graph of its own and replayed under CUDA events
    (timed_ms), 8 slots all speculating over SPEC_PART_ROWS committed
    rows: propose (ngram_propose), the decode step (DecodeGraph.
    spec_decode: every row masked, as when all 8 speculate), the verify
    forward (spec_verify: K2 / K2-int8 and the products at M = 40) and
    accept (greedy picks over the window, accept_greedy, ring pushes, the
    output row), against the whole round's graph. The retained rows are
    dropped first and the pages written here released after."""
    import numpy as np
    import torch

    g = eng._graph
    forget_retained(eng)
    S = g.tokens.shape[0]
    rows = SPEC_PART_ROWS
    for s in range(S):
        if eng._pool is not None:
            eng._pool.ensure(s, rows + 256)
    eng._commit_ptab()
    rng = np.random.default_rng(SEED)
    hi = min(1100, eng.cfg.vocab_size)
    for s in range(S):
        eng.sampler.set_ring(s, rng.integers(3, hi, 256).tolist())
    g.load(np.stack([np.ones(S), np.ones(S), rng.integers(3, hi, S),
                     np.full(S, rows), np.ones(S)]).astype(np.int64))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs, box = {}, {}
    with torch.cuda.stream(stream):
        box["drafts"] = g.spec_propose()
        box["ids0"], box["lps0"] = g.spec_decode(False)
        box["vlogits"] = g.spec_verify(box["drafts"])
        g.step.zero_()
        g.spec_accept(box["drafts"], box["vlogits"], box["ids0"], box["lps0"])
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    parts = {"propose": lambda: g.spec_propose(),
             "decode_step": lambda: g.spec_decode(False),
             "verify": lambda: g.spec_verify(box["drafts"]),
             "accept": lambda: g.spec_accept(box["drafts"], box["vlogits"],
                                             box["ids0"], box["lps0"])}
    for name, fn in parts.items():
        graph = torch.cuda.CUDAGraph()
        g.step.zero_()
        with torch.cuda.graph(graph, stream=stream):
            fn()
        graphs[name] = graph
    ms = {}
    for name, graph in graphs.items():
        ms[name] = timed_ms(lambda graph=graph: (g.step.zero_(), graph.replay()))
    whole = g.spec_graphs[False]
    ms["round"] = timed_ms(lambda: (g.step.zero_(), whole.replay()))
    graphs.clear()
    box.clear()
    for s in range(S):
        if eng._pool is not None:
            eng._pool.release(s, 0)
        eng._cache_tokens[s] = []
    g.load(np.zeros((5, S), np.int64))
    torch.cuda.synchronize()
    ms["parts_sum"] = sum(ms[k] for k in parts)
    return ms


def spec_sets(lm) -> dict:
    """Phase 3i's two prompt sets (8 each): a phrase repeated, and seeded
    random ids."""
    import numpy as np

    phrase_ids = lm.tokenizer.encode(SPEC_PHRASE * 24)
    rng = np.random.default_rng(SEED)
    return {
        "repetitive": [phrase_ids[i:] + lm.tokenizer.encode(f" Line {i}.")
                       for i in range(S_SLOTS)],
        "random": [rng.integers(1000, 100000, 200).tolist() for _ in range(S_SLOTS)],
    }


def spec_phase(lm, card: str, config: str) -> dict:
    """Phase 3i on the loaded model (module doc)."""

    eng = lm.engine
    tag = f"[spec {config}]"
    t0 = time.monotonic()
    tiny = spec_tiny_phase(card) if config == "paged" else None
    log(f"[time] {config}: spec_phase (a) {time.monotonic() - t0:.1f} s")
    sets = spec_sets(lm)
    out = {"tiny_f32": tiny, "sets": {}}
    for name, prompts in sets.items():
        runs = {}
        for spec in (False, True):
            runs[spec] = spec_run(lm, eng, prompts, spec, f"{tag} {name}",
                                  trace=spec and name == "repetitive")
        s, p = runs[True], runs[False]
        same = [sum(a == b for a, b in zip(x, y)) for x, y in
                zip(s["streams"], p["streams"])]
        first_div = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
                     for x, y in zip(s["streams"], p["streams"])]
        share = sum(same) / (S_SLOTS * SPEC_TOKENS)
        for r in runs.values():
            r.pop("streams")
        out["sets"][name] = {"spec": s, "plain": p, "identical_share": share,
                             "first_divergence": first_div,
                             "speedup": s["tok_s"] / p["tok_s"]}
        log(f"{tag} {card}: {name} prompts, 8 x {SPEC_TOKENS} greedy tokens: "
            f"speculation {s['tok_s']:.1f} tok/s vs off {p['tok_s']:.1f} "
            f"({s['tok_s'] / p['tok_s']:.3f}x); spec {s['ms_per_tick']:.2f} ms "
            f"per tick, {s['ms_per_round_or_step']:.2f} ms per round ({s['ticks']} "
            f"ticks, {s['spec_ticks']} spec); off {p['ms_per_tick']:.2f} ms per "
            f"burst, {p['ms_per_round_or_step']:.3f} ms per step; acceptance "
            f"{s['acceptance_rate']:.3f}, {s['accept_per_dispatch']:.3f} tokens "
            f"per slot-round; identical tokens {share * 100:.1f}%, first "
            f"divergence per request {first_div}")
    log(f"[time] {config}: spec_phase (b) greedy {time.monotonic() - t0:.1f} s")
    out["sampled"] = {}
    for name, prompts in sets.items():
        runs = {spec: spec_run(lm, eng, prompts, spec, f"{tag} {name} sampled",
                               sampled=True) for spec in (False, True)}
        s, p = runs[True], runs[False]
        for r in runs.values():
            r.pop("streams")
        out["sampled"][name] = {"spec": s, "plain": p,
                                "speedup": s["tok_s"] / p["tok_s"]}
        log(f"{tag} {card}: {name} prompts, 8 x {SPEC_TOKENS} sampled tokens "
            f"(temperature 0.8, seeded): speculation {s['tok_s']:.1f} tok/s vs off "
            f"{p['tok_s']:.1f} ({s['tok_s'] / p['tok_s']:.3f}x); spec "
            f"{s['ms_per_tick']:.2f} ms per tick, {s['ms_per_round_or_step']:.2f} ms "
            f"per round; acceptance {s['acceptance_rate']:.3f}, "
            f"{s['accept_per_dispatch']:.3f} tokens per slot-round")
    log(f"[time] {config}: spec_phase (b) sampled {time.monotonic() - t0:.1f} s")
    tr = out["sets"]["repetitive"]["spec"].get("trace")
    if tr:
        log(f"{tag} {card}: one spec tick ({out['sets']['repetitive']['spec']['traced_rounds']}"
            f" rounds, 8 slots) under torch.profiler: {tr['kernels_per_step']:.1f} "
            f"CUDA kernels per round, busy {tr['busy_share'] * 100:.1f}% of "
            f"{tr['window_ms']:.2f} ms; top kernels {json.dumps(tr['top10'])}")
    parts = on_engine_thread(eng, lambda: round_parts(eng))
    out["round_parts_ms"] = parts
    log(f"{tag} {card}: the round's parts alone (graph replays, CUDA events, 8 "
        f"slots speculating over {SPEC_PART_ROWS} rows): propose "
        f"{parts['propose']:.3f} ms, decode step {parts['decode_step']:.3f}, "
        f"verify {parts['verify']:.3f}, accept {parts['accept']:.3f} (sum "
        f"{parts['parts_sum']:.3f}) vs the whole round {parts['round']:.3f} ms")
    log(f"[time] {config}: spec_phase (c) {time.monotonic() - t0:.1f} s")
    if config == "paged":
        out["emitter"] = emitter_phase(lm, card, config)
        log(f"[time] {config}: spec_phase (d) {time.monotonic() - t0:.1f} s")
    return out


def emitter_phase(lm, card: str, config: str) -> dict:
    """3i (d): the emitter thread on against off (engines of their own over
    the loaded weights, speculation off as in 3f): 3f's byte gate
    requests, tokens identical on and off, with the engine thread's host
    time per busy tick (``Engine._tick`` timed on the engine thread, less
    the time it waited for results in ``_wait_ready``); then
    3f's mixed traffic, untraced (mixed_run): the arrivals' TTFT and the
    decoding requests' mean inter-token time."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import Engine

    tag = f"[emitter {config}]"
    eos = lm.tokenizer.eos_token_id
    vocab = LLAMA31_8B["vocab_size"]
    gen = np.random.default_rng(SEED + 13)
    gate_specs = [(gen.integers(1000, vocab, n).tolist(), k, forced)
                  for n, k, forced in PIPE_GATE]
    runs = {}
    for on in (True, False):
        eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                     dataclasses.replace(lm.engine.ecfg, emitter=on), device=DEV).start()
        ticks, waits = [], [0.0]
        tick, wait_ready = eng._tick, eng._wait_ready

        def timed_wait(*a, wait_ready=wait_ready, waits=waits, **k):
            t = time.perf_counter()
            try:
                return wait_ready(*a, **k)
            finally:
                waits[0] += time.perf_counter() - t

        def timed_tick(tick=tick, ticks=ticks, waits=waits):
            t, w0 = time.perf_counter(), waits[0]
            busy = tick()
            if busy:
                ticks.append(time.perf_counter() - t - (waits[0] - w0))
            return busy

        eng._tick, eng._wait_ready = timed_tick, timed_wait
        try:
            gate = run_together(eng, pipe_requests(gate_specs, eos), f"{tag} {on}")
            idle_metrics(eng, f"{tag} {on}")
            host = list(ticks)
            # untraced: 3f traces the same load with the emitter on (the
            # default) and holds its gaps
            mixed = mixed_run(eng, np.random.default_rng(SEED + 17),
                              f"{tag} {on} mixed", trace=False)
            m = eng.metrics()
        finally:
            del eng._tick, eng._wait_ready
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        if on != m["emitter"]["enabled"] or (on and not m["emitter"]["emitted"]):
            raise AssertionError(f"{tag} emitter {on}: {m['emitter']}")
        runs[on] = {"gate_ids": [r["ids"] for r in gate],
                    "host_ms_per_tick": sum(host) / max(1, len(host)) * 1e3,
                    "busy_ticks": len(host),
                    "ttft_ms": mixed["ttft_ms"], "itl_ms": mixed["itl_ms"]}
    if runs[True]["gate_ids"] != runs[False]["gate_ids"]:
        raise AssertionError(f"{tag} greedy tokens differ with the emitter on and off")
    out = {}
    for on, r in runs.items():
        r.pop("gate_ids")
        out["on" if on else "off"] = r
        log(f"{tag} {card}: emitter {'on' if on else 'off'}: engine thread "
            f"{r['host_ms_per_tick']:.3f} ms host time per busy tick, waits for "
            f"results excluded ({r['busy_ticks']} ticks, 3f's byte gate, tokens "
            f"identical on and off); 3f's mixed "
            f"traffic: arrivals' TTFT {', '.join(f'{t:.1f}' for t in r['ttft_ms'])} "
            f"ms, decoding requests' mean inter-token time "
            f"{', '.join(f'{t:.2f}' for t in r['itl_ms'])} ms (host clock, "
            f"untraced)")
    return out


# ---------- phase 3k: draft-model speculation ----------

DRAFT_GATE_TOKENS = 60       # (a) tokens of each byte-gate request
DRAFT_ACCEPT_MIN = 0.9       # (a) the target as its own draft, unfused


def draft_tiny_phase(card: str) -> dict:
    """(a) On the card, small f32 models (module doc): for head_dim 128 and
    64, a paged engine with a draft of another shape (hd 64, one layer,
    tied embeddings) at the defaults, and one with the target as its own
    draft and the unfused loop (prefill_packed_fuse "0": no plain burst
    leaves a hole in the draft rows): greedy tokens with the draft ==
    draft "0"'s byte for byte; the target as its own draft accepts >= 90%
    of its proposals; on the hd-64 engine with the other draft, the seeded
    sampled chi-square of 3i (a) against draft "0"."""
    import dataclasses

    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.models import llama

    class Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    V = 96
    targets = {hd: llama.LlamaConfig(
        vocab_size=V, hidden_size=512, intermediate_size=1024, num_layers=2,
        num_heads=512 // hd, num_kv_heads=2, head_dim=hd, rope_theta=500000.0,
        dtype=torch.float32) for hd in (128, DRAFT_HD)}
    other = llama.LlamaConfig(vocab_size=V, hidden_size=256, intermediate_size=512,
                              num_layers=1, num_heads=4, num_kv_heads=2,
                              head_dim=DRAFT_HD, rope_theta=500000.0,
                              tie_word_embeddings=True, dtype=torch.float32)
    dother = random_params(other, SEED + 1, device=DEV)
    base = EngineConfig(num_slots=4, max_context=256, prefill_chunk=32,
                        kv_page_size=16, decode_burst=16, kv_offload=False)
    prompts = [[5, 6, 7, 8] * 8, list(range(10, 50)), [9, 9, 3] * 7, list(range(60, 71))]
    out = {}
    for hd, cfg in targets.items():
        params = random_params(cfg, SEED, device=DEV)
        for name, draft, knobs in (("other", (other, dother), {}),
                                   ("same", (cfg, params),
                                    {"prefill_packed_fuse": "0"})):
            tag = f"[draft tiny hd {hd} {name}]"
            e = Engine(cfg, params, Tok(), dataclasses.replace(base, **knobs),
                       device=DEV, draft=draft).start()
            streams = {}
            try:
                assert e._spec_mode == "model", e._spec_mode
                for mode in ("auto", "0"):
                    pin_speculation(e, mode == "auto")
                    on_engine_thread(e, lambda e=e: forget_retained(e))
                    m0 = dict(e.metrics()["spec"])
                    outs = [e.submit(GenRequest(
                        prompt_ids=list(p), max_new_tokens=DRAFT_GATE_TOKENS,
                        ignore_eos=True, params=SamplingParamsHost(temperature=0.0)))
                            for p in prompts]
                    ids = []
                    for o in outs:
                        got = []
                        while (ev := o.get(timeout=600)) is not None:
                            if ev.error:
                                raise AssertionError(f"{tag} {ev.error}")
                            got.extend(ev.token_ids or [ev.token_id])
                        ids.append(got)
                    m1 = e.metrics()["spec"]
                    streams[mode] = (ids, {k: m1[k] - m0[k] for k in SPEC_KEYS})
                if hd == DRAFT_HD and name == "other":
                    chi = sampled_chi2(e, GenRequest, SamplingParamsHost, prompts)
                    out["sampled_chi2"] = chi
                    log(f"{tag} {card}: {SPEC_CHI_SEEDS} seeded sampled requests x "
                        f"{SPEC_CHI_TOKENS} tokens, the draft vs draft=0: chi2 "
                        f"{chi['stat']:.2f}, dof {chi['dof']}, p {chi['p']:.4f}; "
                        f"{chi['rounds']} sampled rounds, acceptance "
                        f"{chi['acceptance_rate']:.3f}")
            finally:
                e.shutdown()
            (sid, st), (pid, pst) = streams["auto"], streams["0"]
            if sid != pid:
                raise AssertionError(f"{tag} greedy tokens with the draft differ "
                                     f"from draft=0: {sid} vs {pid}")
            if st["rounds"] <= 0 or pst["rounds"] != 0:
                raise AssertionError(f"{tag} spec rounds on / off: {st} / {pst}")
            rate = st["accepted"] / max(1, st["proposed"])
            if name == "same" and rate < DRAFT_ACCEPT_MIN:
                raise AssertionError(f"{tag} the target as its own draft accepted "
                                     f"{rate:.3f} of its proposals (< "
                                     f"{DRAFT_ACCEPT_MIN})")
            out[f"hd{hd}_{name}"] = {"rounds": st["rounds"], "proposed": st["proposed"],
                                     "accepted": st["accepted"], "acceptance_rate": rate}
            log(f"{tag} {card}: f32 greedy tokens with the draft == draft=0 "
                f"({len(prompts)} x {DRAFT_GATE_TOKENS}); {st['rounds']} rounds, "
                f"{st['accepted']} of {st['proposed']} proposals accepted "
                f"({rate:.3f})")
    return out


def load_1b_draft(lm):
    """The 1B draft through the runner's loader (backend/runner.py::
    draft_config / load_draft): phase 3n's GGUF checkpoint (gguf_1b,
    written at its first use), its config, yarn rope included, from the
    file, its Q8_0 tensors dequantized on the host, the target's dtype and
    quantization. Returns (LlamaConfig, params, seconds)."""
    from localai_tpu_torch.backend import runner

    gdir = gguf_1b()["dir"]
    t0 = time.monotonic()
    found = runner.draft_config(lm.model_dir, gdir, lm.cfg.dtype, SEED)
    dcfg, dparams = runner.load_draft(*found, lm.quantization, SEED, DEV,
                                      lm.cfg.vocab_size)
    return dcfg, dparams, time.monotonic() - t0


def draft_host_check(eng, lm, tag: str) -> dict:
    """(d) A speculating request's chain evicted to the host tier and
    restored: its draft planes are in every host entry, the restored
    draft pages equal them byte for byte, and the next turn speculates."""
    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    def run(ids, n):
        out = eng.submit(GenRequest(prompt_ids=list(ids), max_new_tokens=n,
                                    ignore_eos=True,
                                    params=SamplingParamsHost(temperature=0.0)))
        got, reused = [], None
        while (ev := out.get(timeout=600)) is not None:
            if ev.error:
                raise AssertionError(f"{tag} host tier: {ev.error}")
            got.extend(ev.token_ids or [ev.token_id])
            if ev.timings:
                reused = ev.timings["reused_prompt_tokens"]
        return got, reused

    rng = np.random.default_rng(SEED + 5)
    a = rng.integers(1000, 100000, 600).tolist()
    on_engine_thread(eng, lambda: forget_retained(eng))
    first, _r = run(a, 64)
    hist = a + first[:-1]
    # the whole chain leaves the card: evicted, so offloaded with its planes
    on_engine_thread(eng, lambda: forget_retained(eng))
    eng._offloader.join()
    keys = list(eng._pcache.chain_keys(hist))[:len(hist) // eng._pool.page_size]
    ents = [eng._hstore._entries.get(k) for k in keys]
    if not ents or any(e is None or e.dk is None for e in ents):
        raise AssertionError(f"{tag} host tier: {sum(e is not None for e in ents)} of "
                             f"{len(keys)} links offloaded, draft planes on "
                             f"{sum(e is not None and e.dk is not None for e in ents)}")
    planes = [(np.array(e.dk, copy=True) if not isinstance(e.dk, dict)
               else {k: np.array(v, copy=True) for k, v in e.dk.items()}) for e in ents]
    r0 = eng.metrics()["spec"]["rounds"]
    st0 = eng._hstore.stats()
    t0 = time.monotonic()
    second, reused = run(hist + [first[-1]] + rng.integers(1000, 100000, 20).tolist(), 64)
    ms = (time.monotonic() - t0) * 1e3
    st = eng._hstore.stats()
    torch.cuda.synchronize()
    pages = [eng._pcache._entries[k].page for k in keys]
    bad = 0
    for p, want in zip(pages, planes):
        if isinstance(want, dict):
            got = {"q": eng.dck["pages"][:, p].cpu().numpy(),
                   "s": eng.dck["scales"][:, p].cpu().numpy()}
            same = all(np.array_equal(got[k], want[k]) for k in want)
        else:
            got = eng.dck["pages"][:, p].cpu()
            same = np.array_equal(got.view(torch.uint16).numpy()
                                  if got.dtype == torch.bfloat16 else got.numpy(), want)
        bad += not same
    rounds = eng.metrics()["spec"]["rounds"] - r0
    restored = st["restored_pages"] - st0["restored_pages"]
    if bad or restored < len(keys) or reused < len(keys) * eng._pool.page_size:
        raise AssertionError(f"{tag} host tier: {bad} restored draft pages differ "
                             f"from their planes; {restored} pages restored of "
                             f"{len(keys)}; reused {reused}")
    if rounds <= 0:
        raise AssertionError(f"{tag} host tier: the restored slot took no spec round")
    out = {"links": len(keys), "restored_pages": restored, "reused_rows": reused,
           "rounds_after_restore": rounds, "turn2_ms": ms}
    log(f"{tag} host tier: a speculating chain of {len(keys)} pages evicted to host "
        f"RAM with its draft planes and restored: the draft pages byte-equal to the "
        f"planes, {reused} rows reused, {rounds} spec rounds after the restore "
        f"(turn 2, 64 tokens: {ms:.1f} ms, host clock)")
    return out


def draft_phase(lm, card: str, config: str, spec_out: dict) -> dict:
    """Phase 3k on the loaded model (module doc): the 1B draft, an engine
    over the loaded weights with it, the decode rate against 3i's n-gram
    and off runs, the round's parts, one HTTP request, the host tier; for
    paged also the small-model gates (a). The launch counters are zeroed
    just before this engine's requests and read just after them."""
    import dataclasses

    import torch

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import LoadedModel
    from localai_tpu_torch.engine.engine import Engine
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tag = f"[draft {config}]"
    t0 = time.monotonic()
    out = {"tiny_f32": draft_tiny_phase(card) if config == "paged" else None}
    log(f"[time] {config}: draft_phase (a) {time.monotonic() - t0:.1f} s")
    gb0 = torch.cuda.memory_allocated() / 1e9
    dcfg, dparams, load_s = load_1b_draft(lm)
    dgb = param_bytes(dparams) / 1e9
    t_e = time.monotonic()
    eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                 dataclasses.replace(lm.engine.ecfg, draft="auto"), device=DEV,
                 draft=(dcfg, dparams)).start()
    start_s = time.monotonic() - t_e
    try:
        torch.cuda.synchronize()
        m = eng.metrics()
        dkv = sum(t.numel() * t.element_size() for c in (eng.dck, eng.dcv)
                  for k, t in c.items() if k != "ptab")
        pg = m["prefill_graph"]
        out["memory"] = {
            "draft_weights_gb": dgb, "draft_kv_gb": dkv / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9, "before_gb": gb0,
            "draft_load_s": load_s, "engine_start_s": start_s,
            "decode_capture_s": m["decode_graph"]["capture_seconds"],
            "decode_pool_bytes": m["decode_graph"]["pool_bytes"],
            "prefill_capture_s": pg["capture_seconds"],
            "prefill_pool_bytes": pg["pool_bytes"],
            "draft_mirror_capture_s": pg["draft_capture_seconds"],
            "draft_mirror_pool_bytes": pg["draft_pool_bytes"]}
        log(f"{tag} {card}: Llama-3.2-1B widths (hidden {dcfg.hidden_size}, "
            f"{dcfg.num_layers} layers, KV {dcfg.num_kv_heads} x hd {dcfg.head_dim_}, "
            f"tied {dcfg.tie_word_embeddings}, rope {dcfg.rope_scaling_type}), the GGUF "
            f"checkpoint of 3n (Q8_0 from seed {SEED + 1}) as "
            f"{lm.quantization or 'bf16'}: {dgb:.3f} GB weights (10^9 bytes) in "
            f"{load_s:.1f} s (host dequantization included), "
            f"draft KV {dkv / 1e9:.3f} GB over {eng._pool.num_pages} pages; engine "
            f"start {start_s:.1f} s; decode graphs (plain, full, 2 spec rounds with "
            f"the draft) capture {m['decode_graph']['capture_seconds']:.2f} s, pool "
            f"{m['decode_graph']['pool_bytes'] / 1e6:.1f} MB; packs "
            f"{len(pg['captured'])} + {len(pg['draft_captured'])} draft mirrors "
            f"capture {pg['capture_seconds']:.2f} s (mirrors "
            f"{pg['draft_capture_seconds']:.2f} s), pool "
            f"{pg['pool_bytes'] / 1e6:.1f} MB (mirrors {pg['draft_pool_bytes'] / 1e6:.1f});"
            f" memory_allocated {out['memory']['allocated_gb']:.3f} GB "
            f"({gb0:.3f} before the draft)")
        mirrored = [0]
        dispatch = eng._pgraph.dispatch

        def counting(bucket, continued, host, mirror=False, dispatch=dispatch):
            mirrored[0] += int(mirror)
            return dispatch(bucket, continued, host, mirror)

        eng._pgraph.dispatch = counting
        sets = spec_sets(lm)
        m0 = eng.metrics()
        torch.cuda.synchronize()
        reset_launches()
        out["sets"] = {}
        for name, prompts in sets.items():
            r = spec_run(lm, eng, prompts, True, f"{tag} {name}")
            r.pop("streams")
            ng = spec_out["sets"][name]["spec"]
            off = spec_out["sets"][name]["plain"]
            out["sets"][name] = {"model": r, "ngram_3i": ng, "off_3i": off,
                                 "vs_off": r["tok_s"] / off["tok_s"],
                                 "vs_ngram": r["tok_s"] / ng["tok_s"]}
            log(f"{tag} {card}: {name} prompts, 8 x {SPEC_TOKENS} greedy tokens: "
                f"draft model {r['tok_s']:.1f} tok/s, n-gram {ng['tok_s']:.1f}, off "
                f"{off['tok_s']:.1f} (3i, same call) ({r['tok_s'] / off['tok_s']:.3f}x "
                f"off); acceptance {r['acceptance_rate']:.3f} (n-gram "
                f"{ng['acceptance_rate']:.3f}), {r['accept_per_dispatch']:.3f} tokens "
                f"per slot-round (n-gram {ng['accept_per_dispatch']:.3f}); "
                f"{r['ms_per_round_or_step']:.2f} ms per round, {r['ms_per_tick']:.2f} "
                f"per tick ({r['spec_ticks']} spec ticks of {r['ticks']})")
        # one request through the HTTP server, as a client would send it
        app = App({lm.name: LoadedModel(lm.name, lm.model_dir, lm.cfg, lm.tokenizer,
                                        eng, lm.quantization)})
        server = make_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            body = http_json(f"http://127.0.0.1:{server.server_address[1]}"
                             f"/v1/chat/completions",
                             {"model": lm.name, "max_tokens": 48, "ignore_eos": True,
                              "temperature": 0,
                              "messages": [{"role": "user", "content":
                                            "Write three short lines on rain."}]})
        finally:
            server.shutdown()
            server.server_close()
        if body["usage"]["completion_tokens"] != 48:
            raise AssertionError(f"{tag} HTTP chat: {body['usage']}")
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        m1 = eng.metrics()
        del eng._pgraph.dispatch
        dec = {k: m1["decode"][k] - m0["decode"][k] for k in m1["decode"]}
        pk = {k: m1["packed_prefill"][k] - m0["packed_prefill"][k]
              for k in m1["packed_prefill"]}
        n_t, n_d = lm.cfg.num_layers, dcfg.num_layers
        W = eng._spec_width
        dk = DECODE_KERNEL[config]
        k2 = launches["ragged_prefill_attention"] + launches["ragged_prefill_attention_int8"]
        want_dk = n_t * dec["steps"] + n_d * W * dec["spec_rounds"]
        want_k2 = n_t * (pk["dispatches"] + dec["spec_rounds"]) + n_d * mirrored[0]
        must = {"paged": ("paged_decode_attention", "ragged_prefill_attention"),
                "w8kv8": ("paged_decode_attention_quant", "ragged_prefill_attention_int8",
                          "ragged_prefill_attention", W8)}[config]
        missing = [k for k in must if launches[k] <= 0]
        if missing or launches[dk] != want_dk or k2 != want_k2 or mirrored[0] <= 0:
            raise AssertionError(
                f"{tag} launches {launches}: missing {missing}; {dk} {launches[dk]} "
                f"(expected {n_t} x {dec['steps']} steps + {n_d} x {W} x "
                f"{dec['spec_rounds']} rounds = {want_dk}); K2 / K2-int8 {k2} "
                f"(expected {n_t} x ({pk['dispatches']} packs + {dec['spec_rounds']} "
                f"rounds) + {n_d} x {mirrored[0]} mirrors = {want_k2})")
        out["launches"] = {k: v for k, v in launches.items() if v}
        out["counts"] = {"steps": dec["steps"], "spec_rounds": dec["spec_rounds"],
                         "packs": pk["dispatches"], "mirrored_packs": mirrored[0]}
        log(f"{tag} launches over the draft engine's requests (graph replays): "
            f"{json.dumps(out['launches'])}; {dk} = {n_t} x {dec['steps']} + {n_d} x "
            f"{W} x {dec['spec_rounds']}; K2 = {n_t} x ({pk['dispatches']} + "
            f"{dec['spec_rounds']}) + {n_d} x {mirrored[0]} mirrored packs")
        parts = on_engine_thread(eng, lambda: round_parts(eng))
        out["round_parts_ms"] = parts
        log(f"{tag} {card}: the round's parts alone (graph replays, CUDA events, 8 "
            f"slots speculating over {SPEC_PART_ROWS} rows): the draft's {W} steps "
            f"{parts['propose']:.3f} ms ({parts['propose'] / W:.3f} a step; the 1B "
            f"weight-read bound {dgb / (HBM_BYTES_PER_S / 1e9) * 1e3:.3f}), decode "
            f"step {parts['decode_step']:.3f}, verify {parts['verify']:.3f}, accept "
            f"{parts['accept']:.3f} (sum {parts['parts_sum']:.3f}) vs the whole "
            f"round {parts['round']:.3f} ms")
        out["host"] = draft_host_check(eng, lm, tag)
    finally:
        eng.shutdown()
        del eng, dparams
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[time] {config}: draft_phase {time.monotonic() - t0:.1f} s")
    return out


# ---------- phase 3l: grammar ----------

GRAMMAR_VOCAB = 128256          # the written vocabulary (Llama-3's size)
GRAMMAR_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>"}
GRAMMAR_TOKENS = 256            # (b) max_tokens of each of the 8 requests
GRAMMAR_TINY_TOKENS = 64        # (a) max_tokens of each request
GRAMMAR_ROW_STATES = 4          # (a) states re-walked over the full vocabulary
GRAMMAR_CITIES = ("sf", "nyc")
# (b), (c): the constrained requests' logit_bias (+10 on the byte tokens
# ',' and '}' and on EOS, +14 on '"', which ',' and '}' must not outrank
# inside a string): a random model has no reason to close a string or a
# number, its argmax over ~10^5 allowed pieces almost never lands on the
# few that do; the bias rides the grammar's rows as their base
GRAMMAR_BIAS = {ord('"'): 14.0, ord(","): 10.0, ord("}"): 10.0,
                max(GRAMMAR_SPECIALS): 10.0}
# the JAX e2e tool (tests/test_e2e_http.py) with an enum, plus an integer
# and a free string
GRAMMAR_TOOL = {"name": "get_weather", "parameters": {
    "type": "object", "properties": {
        "city": {"enum": list(GRAMMAR_CITIES)}, "days": {"type": "integer"},
        "note": {"type": "string"}},
    "required": ["city", "days", "note"]}}


def grammar_vocab(n: int = GRAMMAR_VOCAB) -> str:
    """Write (once) a byte-level tokenizer.json without merges that the
    port's ByteLevelTokenizer reads, and return its dir: ``n`` entries,
    ids 0-255 the bytes, the two specials at Llama-3's ids 128000 / 128001
    (EOS 128001; with a small ``n``, at n - 2 / n - 1), and pieces of 2-12
    characters drawn from SEED elsewhere, shaped like a BPE vocabulary for
    a JSON grammar: lowercase words, the same after a leading space,
    digit runs, the JSON punctuation { } [ ] " : , alone and in pairs /
    triples, and joined to a word on either side. Nothing is downloaded."""
    import random

    from localai_tpu_torch.engine.tokenizer import bytes_to_unicode

    d = os.path.join(ROOT, "build", "chip_smoke", f"grammar-vocab-{n}")
    if os.path.isfile(os.path.join(d, "tokenizer.json")):
        return d
    os.makedirs(d, exist_ok=True)
    b2u = bytes_to_unicode()
    specials = (GRAMMAR_SPECIALS if n == GRAMMAR_VOCAB else
                {n - 2: GRAMMAR_SPECIALS[128000], n - 1: GRAMMAR_SPECIALS[128001]})
    vocab = {b2u[b]: b for b in range(256)}
    rng = random.Random(SEED)
    lower, digits, punct = "abcdefghijklmnopqrstuvwxyz", "0123456789", '{}[]":,'
    space = b2u[ord(" ")]
    ids = (i for i in range(256, n) if i not in specials)
    for tid in ids:
        while True:
            k, r = rng.randint(2, 12), rng.random()
            word = "".join(rng.choices(lower, k=k))
            if r < 0.45:
                piece = word
            elif r < 0.75:
                piece = space + word[1:]
            elif r < 0.83:               # Llama-3's numbers: 1-3 digits
                piece = "".join(rng.choices(digits, k=2 + k % 2))
            elif r < 0.88:
                piece = "".join(rng.choices(punct, k=rng.randint(1, 3)))
            else:
                p = rng.choice(punct)
                piece = p + word[1:] if rng.random() < 0.5 else word[1:] + p
            if piece not in vocab:
                vocab[piece] = tid
                break
    spec = {"version": "1.0",
            "added_tokens": [{"id": i, "content": c, "special": True}
                             for i, c in sorted(specials.items())],
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "model": {"type": "BPE", "vocab": vocab, "merges": []}}
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": specials[min(specials)],
                   "eos_token": specials[max(specials)]}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"eos_token_id": max(specials)}, f)
    return d


def grammar_texts() -> dict:
    """(a)'s and (b)'s grammars: the tool's call (the chat route's
    grammar for GRAMMAR_TOOL), its arguments alone, and a GBNF list."""
    from localai_tpu_torch.functions.grammars import json_schema

    return {"call": json_schema.grammar_for_functions([GRAMMAR_TOOL]),
            "args": json_schema.schema_to_grammar(GRAMMAR_TOOL["parameters"]),
            "list": 'root ::= "[" [0-9]+ ("," " "? [0-9]+){0,8} "]"'}


def check_call(text: str, tag: str) -> dict:
    """A constrained (b) output: JSON of the tool's call, its enum held."""
    call = json.loads(text)
    args = call["arguments"]
    if (call.get("name") != GRAMMAR_TOOL["name"] or args.get("city") not in GRAMMAR_CITIES
            or not isinstance(args.get("days"), int)
            or not isinstance(args.get("note"), str)):
        raise AssertionError(f"{tag} not a call of the tool's schema: {text!r}")
    return call


def grammar_tiny_phase(card: str, big_tok) -> dict:
    """(a) On the card, phase 2's small float32 model with a 512-entry
    vocabulary cut from the same draw: 4 greedy grammar requests (the
    call, its arguments, the list, the call again from another prompt),
    admitted together, on an engine whose bursts are graph replays and on
    one whose bursts run the eager per-step loop (Engine._burst_eager),
    both with the synchronous loop (pipeline_depth 1, prefill_packed_fuse
    "0": each burst is read before the next is dispatched, so which steps
    sampled under a stale mask does not depend on the card's timing):
    tokens, finishes and rollbacks identical request by request, every
    finished output accepted by the Python automaton. Then the native
    runtime's penalty rows against the Python automaton's over the full
    128,256-entry vocabulary, at the first GRAMMAR_ROW_STATES states the
    call's run visits."""
    import numpy as np

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.engine.tokenizer import load_tokenizer
    from localai_tpu_torch.engine.weights import random_params
    from localai_tpu_torch.functions.grammars import automaton, native

    tag = "[grammar tiny paged]"
    cfg = small_cfg()
    tok = load_tokenizer(grammar_vocab(cfg.vocab_size))
    params = random_params(cfg, SEED, device=DEV)
    g = grammar_texts()
    reqs = [("Call the tool: ", g["call"]), ("Arguments: ", g["args"]),
            ("A list: ", g["list"]), ("Weather please. ", g["call"])]
    ecfg = EngineConfig(num_slots=4, max_context=256, prefill_chunk=64,
                        kv_page_size=16, decode_burst=16, kv_offload=False,
                        pipeline_depth=1, prefill_packed_fuse="0")
    runs = {}
    for way in ("graph", "eager"):
        e = Engine(cfg, params, tok, ecfg, device=DEV).start()
        if way == "eager":
            e._burst = e._burst_eager
        try:
            rolled = {}
            rb = e._rollback_grammar

            def spy(slot, s, rb=rb, rolled=rolled):
                rolled[s.req.request_id] = rolled.get(s.req.request_id, 0) + 1
                return rb(slot, s)

            e._rollback_grammar = spy
            res = run_grammar(e, [GenRequest(
                prompt_ids=tok.encode(p), max_new_tokens=GRAMMAR_TINY_TOKENS,
                grammar=gr, request_id=f"t{i}",
                params=SamplingParamsHost(temperature=0.0))
                for i, (p, gr) in enumerate(reqs)], f"{tag} {way}")
            for r in res:
                r["rollbacks"] = rolled.get(r["rid"], 0)
            runs[way] = res
        finally:
            e.shutdown()
    for i, (a, b) in enumerate(zip(runs["graph"], runs["eager"])):
        if (a["ids"], a["finish"], a["rollbacks"]) != (b["ids"], b["finish"],
                                                       b["rollbacks"]):
            raise AssertionError(f"{tag} request {i}: graph {a['ids']} "
                                 f"{a['finish']} ({a['rollbacks']} rollbacks) vs "
                                 f"eager {b['ids']} {b['finish']} ({b['rollbacks']})")
    for (_p, gr), r in zip(reqs, runs["graph"]):
        st = automaton.Grammar.from_text(gr)
        ok = (st.accepts(r["text"]) if r["finish"] == "stop" else
              st.advance_string(st.initial_state(), r["text"]) is not None)
        if not ok:
            raise AssertionError(f"{tag} output outside its grammar: {r['text']!r}")
    # the states the call's run visits, re-walked over the full vocabulary
    t0 = time.monotonic()
    strs = automaton.token_strings(big_tok)
    eos = [big_tok.eos_token_id]
    pg = automaton.Grammar.from_text(g["call"])
    ng = native.NativeGrammar.from_text(g["call"])
    py_b = automaton.TokenMaskBuilder(strs, eos, GRAMMAR_VOCAB)
    na_b = native.NativeMaskBuilder(strs, eos, GRAMMAR_VOCAB)
    small = automaton.token_strings(tok)
    ps, ns, seen, states = pg.initial_state(), ng.initial_state(), set(), []
    for tid in [None] + runs["graph"][0]["ids"]:
        if tid is not None:
            if tid == tok.eos_token_id:
                break
            ps = pg.advance_string(ps, small[tid])
            ns = ng.advance_string(ns, small[tid])
        if ps not in seen:
            seen.add(ps)
            states.append((ps, ns))
        if len(states) == GRAMMAR_ROW_STATES:
            break
    allowed = []
    for ps, ns in states:
        pr, nr = py_b.penalty_row(pg, ps), na_b.penalty_row(ng, ns)
        if not np.array_equal(pr, nr):
            raise AssertionError(f"{tag} native row != Python row at a visited "
                                 f"state ({int((pr != nr).sum())} entries differ)")
        allowed.append(int((nr == 0).sum()))
    rows_s = time.monotonic() - t0
    out = {"requests": [{k: r[k] for k in ("finish", "rollbacks")}
                        | {"tokens": len(r["ids"])} for r in runs["graph"]],
           "rows_checked": len(states), "allowed_per_state": allowed,
           "rows_seconds": rows_s}
    log(f"{tag} {card}: f32 grammar streams, graph == eager (synchronous loop): "
        f"{[(len(r['ids']), r['finish'], r['rollbacks']) for r in runs['graph']]} "
        f"(tokens, finish, rollbacks); every output in its grammar; native rows == "
        f"Python rows at {len(states)} visited states over {GRAMMAR_VOCAB} entries "
        f"(allowed tokens {allowed}; {rows_s:.1f} s host)")
    return out


def run_grammar(eng, reqs, tag, t_gate=None) -> list:
    """Queue ``reqs`` with admission held, open it, read every stream (on
    reader threads); per request its ids, text, finish, first-token and
    last-token times (host clock, from the gate's opening) and whether it
    carried a grammar. Errors raise."""
    gate = threading.Event()
    admit = eng._admit
    eng._admit = lambda admit=admit: gate.is_set() and admit()
    res = [None] * len(reqs)

    def read(i, out, t0):
        ids, text, fin, t_first, err = [], "", None, None, None
        while (ev := out.get(timeout=900)) is not None:
            if ev.error:
                err = ev.error
            t_first = t_first or time.monotonic()
            ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
            text += ev.text
            fin = ev.finish_reason or fin
        res[i] = {"rid": reqs[i].request_id, "ids": ids, "text": text,
                  "finish": fin, "error": err, "grammar": bool(reqs[i].grammar),
                  "ttft_s": (t_first or time.monotonic()) - t0[0],
                  "last_s": time.monotonic() - t0[0]}

    t0 = [0.0]
    try:
        outs = [eng.submit(r) for r in reqs]
        threads = [threading.Thread(target=read, args=(i, o, t0), daemon=True)
                   for i, o in enumerate(outs)]
        for t in threads:
            t.start()
        t0[0] = time.monotonic()
        gate.set()
        eng._wake.set()
        for t in threads:
            t.join(timeout=900)
    finally:
        del eng._admit
    bad = [r for r in res if r is None or r["error"]]
    if bad:
        raise AssertionError(f"{tag} requests failed: {bad}")
    return res


def grammar_mixed(eng, tok, prompts, grammar, tag, sampled: bool,
                  free_only: bool = False) -> dict:
    """(b) One run of the 8 requests: the first four under ``grammar``
    (none with ``free_only``), the rest free (ignore_eos); greedy or seeded
    sampled (temperature 1). Returns the per-class rates and the grammar
    counters of the run; every bias flush's device time is taken with CUDA
    events around it (Engine.sampler.write_bias_rows)."""
    import torch

    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    flushes = []
    write = eng.sampler.write_bias_rows

    def timed_write(slots, rows, write=write):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        write(slots, rows)
        b.record()
        flushes.append((a, b, len(slots), time.perf_counter() - t))

    eng.sampler.write_bias_rows = timed_write
    try:
        m0 = eng.metrics()
        reqs = [GenRequest(
            prompt_ids=tok.encode(p), max_new_tokens=GRAMMAR_TOKENS,
            grammar="" if free_only or i >= 4 else grammar,
            ignore_eos=free_only or i >= 4, request_id=f"{tag}-{i}",
            params=SamplingParamsHost(
                temperature=1.0 if sampled else 0.0, seed=SEED + i,
                logit_bias={} if free_only or i >= 4 else dict(GRAMMAR_BIAS)))
            for i, p in enumerate(prompts)]
        res = run_grammar(eng, reqs, tag)
        torch.cuda.synchronize()
        m1 = eng.metrics()
    finally:
        del eng.sampler.write_bias_rows
    gm = {k: m1["grammar"][k] - m0["grammar"][k] for k in m1["grammar"]}
    dec = {k: m1["decode"][k] - m0["decode"][k] for k in m1["decode"]}
    for r in res:
        if r["grammar"]:
            if r["finish"] != "stop":
                raise AssertionError(f"{tag} a constrained request ended "
                                     f"{r['finish']!r}: {r['text']!r}")
            check_call(r["text"], tag)
        elif len(r["ids"]) != GRAMMAR_TOKENS:
            raise AssertionError(f"{tag} a free request gave {len(r['ids'])} tokens")

    def rate(rs):
        toks = sum(len(r["ids"]) - 1 for r in rs)
        wall = max(r["last_s"] for r in rs) - min(r["ttft_s"] for r in rs)
        return toks / max(1e-9, wall)

    g_res = [r for r in res if r["grammar"]]
    f_res = [r for r in res if not r["grammar"]]
    dev_ms = [a.elapsed_time(b) for a, b, _n, _h in flushes]
    out = {"free_tok_s": rate(f_res),
           "grammar_tok_s": rate(g_res) if g_res else None,
           "grammar_tokens": [len(r["ids"]) for r in g_res],
           "ttft_ms_grammar": [r["ttft_s"] * 1e3 for r in g_res],
           "ttft_ms_free": [r["ttft_s"] * 1e3 for r in f_res],
           "rollbacks": gm["rollbacks"], "advances": gm["tokens"],
           "rollbacks_per_token": gm["rollbacks"] / max(1, gm["tokens"]),
           "host_ms_per_token": gm["advance_s"] * 1e3 / max(1, gm["tokens"]),
           "memo_hit_share": gm["memo_hits"] / max(1, gm["memo_hits"]
                                                  + gm["memo_misses"]),
           "flushes": len(flushes),
           "rows_per_flush": sum(n for *_x, n, _h in flushes) / max(1, len(flushes)),
           "flushes_per_burst": len(flushes) / max(1, dec["bursts"]),
           "flush_device_ms_median": (sorted(dev_ms)[len(dev_ms) // 2]
                                      if dev_ms else None),
           "flush_host_ms_median": (sorted(h for *_x, h in flushes)[len(flushes) // 2]
                                    * 1e3 if flushes else None),
           "bursts": dec["bursts"], "spec_ticks": dec["spec_ticks"],
           "steps": dec["steps"], "texts": [r["text"] for r in g_res[:2]]}
    return out


def grammar_phase(lm, card: str, config: str) -> dict:
    """Phase 3l on the loaded model (module doc): (a) paged only, the small
    f32 model's gates; the vocabulary's cold costs; (b) an engine over the
    loaded weights with the written 128,256-entry tokenizer, 8 requests
    (4 under the tool's call grammar) greedy and sampled with speculation
    at its default, and the same prompts all free; (c) the tool call over
    HTTP, streamed and not. The launch counters are zeroed just before
    (b)'s runs and read just after (c)."""
    import dataclasses

    import torch

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import LoadedModel
    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.engine.tokenizer import load_tokenizer
    from localai_tpu_torch.functions.grammars import automaton, native
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tag = f"[grammar {config}]"
    t0 = time.monotonic()
    tok = load_tokenizer(grammar_vocab())
    if len(automaton.token_strings(tok)) != GRAMMAR_VOCAB:
        raise AssertionError(f"{tag} the written vocabulary is not {GRAMMAR_VOCAB}")
    out = {"tiny_f32": grammar_tiny_phase(card, tok) if config == "paged" else None}
    log(f"[time] {config}: grammar_phase (a) {time.monotonic() - t0:.1f} s")
    g = grammar_texts()
    # the cold costs at admission, over the 128,256 entries (host clock)
    t = time.perf_counter()
    strs = automaton.token_strings(tok)
    strs_s = time.perf_counter() - t
    t = time.perf_counter()
    builder = native.NativeMaskBuilder(strs, [tok.eos_token_id], GRAMMAR_VOCAB)
    build_s = time.perf_counter() - t
    gr = native.NativeGrammar.from_text(g["call"])
    st = gr.initial_state()
    t = time.perf_counter()
    builder.penalty_row(gr, st)
    cold_ms = (time.perf_counter() - t) * 1e3
    mid = gr.advance_string(st, '{"name": "get_weather", "arguments": '
                                '{"city": "sf", "days": 3, "note": "ab')
    t = time.perf_counter()
    row = builder.penalty_row(gr, mid)
    cold_string_ms = (time.perf_counter() - t) * 1e3
    out["cold"] = {"token_strings_s": strs_s, "mask_builder_s": build_s,
                   "penalty_row_initial_ms": cold_ms,
                   "penalty_row_in_string_ms": cold_string_ms,
                   "allowed_in_string": int((row == 0).sum())}
    log(f"{tag} {card}: the vocabulary's cold costs (host): token strings "
        f"{strs_s:.2f} s, native mask builder {build_s:.2f} s, cold penalty_row "
        f"{cold_ms:.3f} ms at the call's first state, {cold_string_ms:.3f} ms inside "
        f"its free string ({out['cold']['allowed_in_string']} tokens allowed)")
    del builder, gr
    eng = Engine(lm.cfg, lm.engine.params, tok,
                 dataclasses.replace(lm.engine.ecfg, draft="auto"),
                 device=DEV).start()
    try:
        # warm: the engine builds its token strings and mask builder at
        # its first grammar request (as the JAX engine does)
        run_grammar(eng, [GenRequest(prompt_ids=tok.encode("Warm up: "),
                                     max_new_tokens=8, grammar=g["call"],
                                     params=SamplingParamsHost(temperature=0.0))],
                    f"{tag} warm")
        prompts = [f"Request {i}: what is the weather in "
                   f"{GRAMMAR_CITIES[i % 2]} for the next {i + 2} days? "
                   f"Answer with a call of the tool." for i in range(S_SLOTS)]
        torch.cuda.synchronize()
        reset_launches()
        m0 = eng.metrics()
        runs = {}
        for name, kw in (("greedy", {"sampled": False}), ("sampled", {"sampled": True}),
                         ("all_free", {"sampled": False, "free_only": True})):
            runs[name] = grammar_mixed(eng, tok, prompts, g["call"],
                                       f"{tag} {name}", **kw)
        # (c) the tool call through the HTTP server
        app = App({lm.name: LoadedModel(lm.name, lm.model_dir, lm.cfg, tok, eng,
                                        lm.quantization)})
        server = make_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions"
        body = {"model": lm.name, "max_tokens": GRAMMAR_TOKENS, "temperature": 1.0,
                "seed": SEED, "logit_bias": {str(k): v for k, v in GRAMMAR_BIAS.items()},
                "messages": [{"role": "user", "content":
                                            "What is the weather in sf?"}],
                "tools": [{"type": "function", "function": GRAMMAR_TOOL}],
                "tool_choice": {"type": "function",
                                "function": {"name": GRAMMAR_TOOL["name"]}}}
        try:
            plain = http_json(url, body)
            chunks = http_stream(url, {**body, "stream": True, "seed": SEED + 1})[0]
        finally:
            server.shutdown()
            server.server_close()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        m1 = eng.metrics()
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    ch = plain["choices"][0]
    calls = ch["message"].get("tool_calls") or []
    s_calls = [c for k in chunks for c in k["choices"][0]["delta"].get("tool_calls") or ()]
    for cs, fin in ((calls, ch["finish_reason"]),
                    (s_calls, chunks[-1]["choices"][0]["finish_reason"])):
        if fin != "tool_calls" or len(cs) != 1:
            raise AssertionError(f"{tag} HTTP tool call: finish {fin!r}, calls {cs}")
        check_call(json.dumps({"name": cs[0]["function"]["name"], "arguments":
                               json.loads(cs[0]["function"]["arguments"])}), tag)
    out["http"] = {"non_stream": calls[0]["function"],
                   "stream": s_calls[0]["function"]}
    dec = {k: m1["decode"][k] - m0["decode"][k] for k in m1["decode"]}
    pk = {k: m1["packed_prefill"][k] - m0["packed_prefill"][k]
          for k in m1["packed_prefill"]}
    n_t = lm.cfg.num_layers
    dk = DECODE_KERNEL[config]
    k2 = launches["ragged_prefill_attention"] + launches["ragged_prefill_attention_int8"]
    must = {"paged": ("paged_decode_attention", "ragged_prefill_attention"),
            "w8kv8": ("paged_decode_attention_quant", "ragged_prefill_attention_int8",
                      W8)}[config]
    missing = [k for k in must if launches[k] <= 0]
    if (missing or launches[dk] != n_t * dec["steps"]
            or k2 != n_t * (pk["dispatches"] + dec["spec_rounds"])):
        raise AssertionError(
            f"{tag} launches {launches}: missing {missing}; {dk} {launches[dk]} "
            f"(expected {n_t} x {dec['steps']} steps); K2 / K2-int8 {k2} (expected "
            f"{n_t} x ({pk['dispatches']} packs + {dec['spec_rounds']} rounds))")
    if runs["greedy"]["spec_ticks"] <= 0:
        raise AssertionError(f"{tag} the free requests took no spec tick beside "
                             f"the grammar ones: {runs['greedy']}")
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["counts"] = {"steps": dec["steps"], "spec_rounds": dec["spec_rounds"],
                     "packs": pk["dispatches"]}
    out["runs"] = runs
    for name, r in runs.items():
        log(f"{tag} {card}: {name}, 8 x {GRAMMAR_TOKENS} max tokens "
            + (f"(4 under the tool's call grammar, 4 free): grammar slots "
               f"{r['grammar_tok_s']:.1f} tok/s ({r['grammar_tokens']} tokens, "
               f"every one a call of the schema ending \"stop\"), free slots "
               f"{r['free_tok_s']:.1f} tok/s; rollbacks {r['rollbacks']} = "
               f"{r['rollbacks_per_token']:.3f} per grammar token; host "
               f"{r['host_ms_per_token']:.4f} ms per grammar token (advance + "
               f"mask lookup), memo hits {r['memo_hit_share'] * 100:.1f}%; "
               f"{r['flushes']} flushes ({r['flushes_per_burst']:.2f} per burst, "
               f"{r['rows_per_flush']:.2f} rows each; device "
               f"{r['flush_device_ms_median']:.4f} ms, host "
               f"{r['flush_host_ms_median']:.4f} ms median); TTFT grammar "
               f"{[round(x, 1) for x in r['ttft_ms_grammar']]} ms vs free "
               f"{[round(x, 1) for x in r['ttft_ms_free']]} ms"
               if r["grammar_tok_s"] is not None else
               f"all free: {r['free_tok_s']:.1f} tok/s (the same prompts)")
            + f"; {r['spec_ticks']} spec ticks of {r['bursts']} ticks")
    log(f"{tag} HTTP tool call (forced tool_choice, temperature 1): "
        f"{json.dumps(out['http'])}")
    log(f"{tag} launches over (b) and (c) (graph replays): "
        f"{json.dumps(out['launches'])}; {dk} = {n_t} x {dec['steps']} steps; K2 = "
        f"{n_t} x ({pk['dispatches']} packs + {dec['spec_rounds']} rounds)")
    return out


# ---------- phase 3j: observability ----------

def prom_values(text: str) -> dict:
    """{sample name with its labels: value} of a Prometheus text (an
    exemplar suffix dropped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]
        key, _, value = line.rpartition(" ")
        out[key] = float(value)
    return out


def observability_checks(lm, base: str, config: str, cids: list) -> dict:
    """Phase 3's observability checks at the defaults (trace and kv_audit
    on), right after its requests, the engine idle: GET /metrics answers
    200 with the Prometheus content type, and its packed-prefill, decode
    (bursts and tokens) and speculation counters equal metrics(); every
    request's X-Correlation-ID has a "request" span in /debug/trace and
    "admit" and "complete" events in /debug/events; /debug/kv shows audit
    checks > 0 and 0 violations (the contiguous layout: {"mode": "off"});
    no graph was captured and no kernel built after start."""
    from localai_tpu_torch.services.metrics import CONTENT_TYPE

    tag = f"[obs {config}]"
    name = lm.name
    lab = f'{{model="{name}"}}'
    idle_metrics(lm.engine, tag)
    st, ct, text = http_text(base + "/metrics")
    m = lm.engine.metrics()
    if st != 200 or ct != CONTENT_TYPE:
        raise AssertionError(f"{tag} /metrics answered {st} {ct!r}")
    got = prom_values(text)
    h = m["histograms"]
    sp = m["spec"]
    want = {
        f"localai_prefill_packed_dispatches_total{lab}": m["packed_prefill"]["dispatches"],
        f"localai_prefill_packed_tokens_total{lab}": m["packed_prefill"]["tokens"],
        f"localai_decode_burst_seconds_count{lab}": h["decode_burst_seconds"]["count"],
        f"localai_goodput_tokens_total{lab}": m["sysobs"]["goodput"]["goodput_tokens_total"],
        f"localai_ttft_seconds_count{lab}": h["ttft_seconds"]["count"],
        f"localai_spec_rounds_total{lab}": sp["rounds"],
        f"localai_spec_proposed_total{lab}": sp["proposed"],
        f"localai_spec_accepted_total{lab}": sp["accepted"],
    }
    for mode, c in sp["by_mode"].items():
        want[f'localai_spec_rounds_total{{mode="{mode}",model="{name}"}}'] = c["rounds"]
    if sp["mode"] == "off":                 # no speculation: no spec family
        want = {k: v for k, v in want.items() if "_spec_" not in k}
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"{tag} /metrics against metrics(): {bad}")
    if h["decode_burst_seconds"]["count"] != m["decode"]["bursts"]:
        raise AssertionError(f"{tag} bursts processed {h['decode_burst_seconds']['count']}"
                             f" != dispatched {m['decode']['bursts']}")
    trace = json.loads(http_text(base + "/debug/trace")[2])
    spans = {ev["args"].get("request_id") for ev in trace["traceEvents"]
             if ev.get("name") == "request"}
    evs = json.loads(http_text(base + "/debug/events?last=512")[2])["events"]
    seen = {}
    for ev in evs:
        seen.setdefault(ev.get("rid"), []).append(ev["event"])
    missing = [c for c in cids if c not in spans
               or not {"admit", "complete"} <= set(seen.get(c, ()))]
    if missing:
        raise AssertionError(f"{tag} no request span or admit / complete event "
                             f"for {missing}")
    kv = json.loads(http_text(base + "/debug/kv")[2])["models"][name]
    if lm.engine.kv_layout == "paged":
        if kv["mode"] != "on" or kv["audit"]["checks"] <= 0 or kv["audit"]["violations"]:
            raise AssertionError(f"{tag} /debug/kv audit {kv.get('audit')}")
    elif kv != {"mode": "off", "replica": 0}:
        raise AssertionError(f"{tag} /debug/kv of the contiguous layout: {kv}")
    comp = m["sysobs"]["compiles"]
    if comp["compiles_after_warmup"] or not comp["warm"]:
        raise AssertionError(f"{tag} captures / builds after start: {comp}")
    tr = m["trace"]
    out = {"metrics_lines": len(got), "checked": len(want),
           "audit": {k: kv["audit"][k] for k in ("checks", "violations",
                                                 "leaked_pages", "ledger_events")}
           if kv["mode"] != "off" else {"mode": "off"},
           "spans_recorded": tr["spans_recorded"], "decomp_ms": tr["decomp_ms"],
           "compiles": comp}
    log(f"{tag} /metrics: {len(got)} samples, {len(want)} held to metrics(); "
        f"{len(cids)} correlation ids with their request span and admit / "
        f"complete events; audit {out['audit']}; "
        f"{tr['spans_recorded']} spans, decomp_ms {json.dumps(tr['decomp_ms'])}; "
        f"compiles {json.dumps(comp)}")
    return out


def obs_phase(lm, card: str, config: str) -> dict:
    """Phase 3j (module doc), on the loaded weights: (a) the card's
    allocator counters as the engine reads them against
    torch.cuda.memory_stats(), and MFU with its peak; (b) the cost of the
    observability: engines at the defaults (trace and kv_audit on) and at
    trace=False, kv_audit="off", speculation off as in 3b / 3f, built in
    turn in this call: 3b's decode ms/step (the graph), and 3f's mixed
    traffic untraced (the arrivals' TTFT, the decoding requests' mean
    inter-token time) with the tracer's decomp_ms over that window beside
    the device ms of the same packs and bursts from CUDA events (3f prints
    the tracer's decomp_ms of its traced run beside the profiler's busy
    share). Printed, not gated."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import Engine

    tag = f"[obs {config}]"
    out = {}
    # (a) on the loaded engine, idle
    m = lm.engine.metrics()
    dm = m["sysobs"].get("device_mem") or {}
    st = torch.cuda.memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    if not dm or dm["bytes_limit"] != total or abs(
            dm["bytes_in_use"] - st["allocated_bytes.all.current"]) > 64 << 20:
        raise AssertionError(f"{tag} device_mem {dm} against memory_stats "
                             f"{st['allocated_bytes.all.current']} / {total}")
    out["device_mem"] = {"engine": dm,
                         "memory_stats": {"allocated_current": st["allocated_bytes.all.current"],
                                          "allocated_peak": st["allocated_bytes.all.peak"],
                                          "total_memory": total}}
    log(f"{tag} (a) {card}: device_mem {json.dumps(dm)}; torch.cuda.memory_stats "
        f"allocated {st['allocated_bytes.all.current']} (peak "
        f"{st['allocated_bytes.all.peak']}), total {total}")
    runs = {}
    for label, knobs in (("defaults", {}),
                         ("off", {"trace": False, "kv_audit": "off"})):
        eng = Engine(lm.cfg, lm.engine.params, lm.tokenizer,
                     dataclasses.replace(lm.engine.ecfg, draft="0", **knobs),
                     device=DEV).start()
        try:
            dec = decode_phase(dataclasses.replace(lm, engine=eng), card, config,
                               ways=("graph",), label=f"obs {label}")["graph"]
            gp = eng.metrics()["sysobs"]["goodput"]
            evs = []

            def timed(fn, evs=evs):
                def run(*a, **k):
                    s0 = torch.cuda.Event(enable_timing=True)
                    s0.record()
                    res = fn(*a, **k)
                    s1 = torch.cuda.Event(enable_timing=True)
                    s1.record()
                    evs.append((s0, s1))
                    return res
                return run

            eng._burst, eng._prefill_pack = timed(eng._burst), timed(eng._prefill_pack)
            try:
                mixed = mixed_run(eng, np.random.default_rng(SEED + 17),
                                  f"{tag} {label} mixed", trace=False)
            finally:
                del eng._burst, eng._prefill_pack
            torch.cuda.synchronize()
            dev_ms = sum(a.elapsed_time(b) for a, b in evs)
            run = {"decode_ms_per_step": dec["ms_per_step"],
                   "decode_ms_min_max": [dec["ms_per_step_min"], dec["ms_per_step_max"]],
                   "ttft_ms": mixed["ttft_ms"], "itl_ms": mixed["itl_ms"],
                   "cuda_events_device_ms": dev_ms, "dispatches_timed": len(evs),
                   "mfu": gp["mfu"], "goodput_tok_s": gp["goodput_tok_s"],
                   "peak_flops": gp["peak_flops"]}
            if mixed["decomp_ms"]:
                run["decomp_ms"] = mixed["decomp_ms"]
            if label == "defaults":
                if not gp["mfu"] > 0 or not gp["peak_flops"] > 0:
                    raise AssertionError(f"{tag} MFU {gp}")
                ka = eng.kv_audit_sweep()
                if ka["violations"] or ka["checks"] <= 0:
                    raise AssertionError(f"{tag} audit {ka}")
                run["audit_checks"] = ka["checks"]
        finally:
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        runs[label] = run
        log(f"{tag} (b) {card}: {label}: decode {run['decode_ms_per_step']:.3f} "
            f"ms/step (graph, 3b's run); 3f's mixed traffic untraced: arrivals' "
            f"TTFT {', '.join(f'{t:.1f}' for t in run['ttft_ms'])} ms, decoding "
            f"requests' mean inter-token time "
            f"{', '.join(f'{t:.2f}' for t in run['itl_ms'])} ms; device ms of its "
            f"{len(evs)} packs and bursts by CUDA events {dev_ms:.1f}"
            + (f", tracer decomp_ms {json.dumps(run['decomp_ms'])}"
               if "decomp_ms" in run else ", tracer off")
            + f"; MFU {run['mfu']:.6f} at peak {run['peak_flops']:.4g} FLOP/s "
            f"(goodput {run['goodput_tok_s']:.1f} tok/s)")
    out["cost"] = runs
    return out


# ---------- phase 3m: the front door (run --models-path) ----------

FD_DIR = os.path.join(ROOT, "build", "chip_smoke", "front_door")
FD_MODEL = "llama-3.1-8b-fd"        # the model dir the YAML names
FD_NAME = "llama3"                  # the served name (the YAML's)
FD_BOS, FD_HEADER, FD_END_HEADER, FD_EOT = 128000, 128006, 128007, 128009
# Llama-3's split regex (meta-llama/Meta-Llama-3-8B's tokenizer.json)
FD_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
            r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
FD_NAMED = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
            128004: "<|finetune_right_pad_id|>", 128006: "<|start_header_id|>",
            128007: "<|end_header_id|>", 128008: "<|eom_id|>",
            128009: "<|eot_id|>", 128010: "<|python_tag|>"}
# the first merges spell " hello" (its token is what 3m's forced output
# is made of); the rest join two earlier tokens drawn from SEED
FD_FIRST_MERGES = [("h", "e"), ("he", "l"), ("hel", "l"), ("hell", "o"),
                   ("Ġ", "hello")]
FD_YAML = f"""\
# written by chip_smoke.py phase 3m: no templates (the llama3 family is
# guessed from the tokenizer config), random weights from the seed
name: {FD_NAME}
parameters:
  model: {FD_MODEL}
  temperature: 0.7
  top_p: 0.9
  max_tokens: 16
cutstrings: ["l+"]
trimspace: [" "]
options:
  - random_weights={SEED}
"""
FD_TEXTS = 200
FD_WORDS = ["the", "The", "paged", "attention", "card", "hello", "world",
            "don't", "it's", "we'll", "I'M", "12345", "3.14", "2024-10-18",
            "naïve", "café", "日本語", "नमस्ते", "😀", "²½Ⅻ", "é",
            "  ", "\n", "\n\n", "\t", "...", "?!", "(x)", "<|eot_id|>",
            "<|start_header_id|>"]


def fd_byte_table() -> dict:
    """GPT-2's byte -> printable character table (this phase's own)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def fd_vocab() -> tuple:
    """(vocab, merges) of 128,256 entries: the 256 byte characters, 127,744
    merges each joining two earlier tokens (letters and the space
    character, a space only at a token's start, up to 12 characters;
    drawn from SEED, earlier tokens likelier), the 256 specials at
    128000-128255."""
    import numpy as np

    b2u = fd_byte_table()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    pool = [b2u[b] for b in b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ "]
    for a, b in FD_FIRST_MERGES:
        vocab[a + b] = len(vocab)
        merges.append((a, b))
        pool.append(a + b)
    rng = np.random.default_rng(SEED)
    n_merges = 128000 - 256
    while len(merges) < n_merges:
        u = rng.random((4096, 2)) ** 2
        for ua, ub in u:
            a, b = pool[int(ua * len(pool))], pool[int(ub * len(pool))]
            m = a + b
            if b[0] == "Ġ" or len(m) > 12 or m in vocab:
                continue
            vocab[m] = len(vocab)
            merges.append((a, b))
            pool.append(m)
            if len(merges) == n_merges:
                break
    k = 0
    for i in range(128000, 128256):
        name = FD_NAMED.get(i)
        if name is None:
            name = f"<|reserved_special_token_{k}|>"
            k += 1
        vocab[name] = i
    return vocab, merges


def fd_write(vocab: dict, merges: list) -> str:
    """The models dir: the YAML file, and the model dir with Llama-3.1-8B's
    config.json, the tokenizer.json and a tokenizer_config.json whose
    chat_template marks the llama3 family."""
    models = os.path.join(FD_DIR, "models")
    mdir = os.path.join(models, FD_MODEL)
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, "config.json"), "w") as f:
        json.dump(dict(LLAMA31_8B, eos_token_id=FD_EOT), f)
    specials = [{"id": i, "content": s, "single_word": False, "lstrip": False,
                 "rstrip": False, "normalized": False, "special": True}
                for s, i in vocab.items() if i >= 128000]
    bos = {"SpecialToken": {"id": FD_NAMED[FD_BOS], "type_id": 0}}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": specials, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": FD_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}}, bos,
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {FD_NAMED[FD_BOS]: {
                 "id": FD_NAMED[FD_BOS], "ids": [FD_BOS],
                 "tokens": [FD_NAMED[FD_BOS]]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": True,
                  "vocab": {s: i for s, i in vocab.items() if i < 128000},
                  "merges": [f"{a} {b}" for a, b in merges]}}
    with open(os.path.join(mdir, "tokenizer.json"), "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(mdir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": FD_NAMED[FD_BOS], "eos_token": FD_NAMED[FD_EOT],
                   "clean_up_tokenization_spaces": False,
                   "chat_template": "{% for m in messages %}<|start_header_id|>"
                                    "{{ m['role'] }}<|end_header_id|>{% endfor %}"},
                  f)
    with open(os.path.join(models, f"{FD_NAME}.yaml"), "w") as f:
        f.write(FD_YAML)
    return models


def fd_reference(vocab: dict, merges: list):
    """A reference encoder written here, independent of the port's: the
    specials split out leftmost-longest, Llama-3's split regex over
    unicodedata's letter / number classes and Unicode White_Space, the
    byte table, then the naive loop over all pairs (lowest rank, leftmost;
    a word in the vocabulary whole stays whole), BOS first."""
    import re
    import unicodedata

    def cls(major):
        out, start = [], None
        for c in range(sys.maxunicode + 2):
            hit = c <= sys.maxunicode and unicodedata.category(chr(c))[0] == major
            if hit and start is None:
                start = c
            elif not hit and start is not None:
                out.append(f"\\U{start:08x}-\\U{c - 1:08x}")
                start = None
        return "".join(out)

    L, N = cls("L"), cls("N")
    ws = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
    split = re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]{{1,3}}"
        rf"| ?[^{ws}{L}{N}]+[\r\n]*|[{ws}]*[\r\n]+|[{ws}]+(?![^{ws}])|[{ws}]+")
    specials = sorted((s for s, i in vocab.items() if i >= 128000),
                      key=len, reverse=True)
    ranks = {m: r for r, m in enumerate(merges)}
    b2u = fd_byte_table()

    def words(seg):
        out, pos = [], 0
        for m in split.finditer(seg):
            if m.start() > pos:
                out.append(seg[pos:m.start()])
            out.append(m.group())
            pos = m.end()
        if pos < len(seg):
            out.append(seg[pos:])
        return out

    def encode(text):
        ids, i, plain = [FD_BOS], 0, ""
        segs = []
        while i < len(text):
            hit = next((s for s in specials if text.startswith(s, i)), None)
            if hit is None:
                plain += text[i]
                i += 1
                continue
            segs.append(plain)
            segs.append(hit)
            plain, i = "", i + len(hit)
        segs.append(plain)
        for seg in segs:
            if seg in vocab and vocab[seg] >= 128000:
                ids.append(vocab[seg])
                continue
            for w in words(seg):
                mapped = "".join(b2u[b] for b in w.encode("utf-8"))
                if mapped in vocab:
                    ids.append(vocab[mapped])
                    continue
                parts = list(mapped)
                while len(parts) > 1:
                    r, k = min((ranks.get((parts[k], parts[k + 1]), 1 << 30), k)
                               for k in range(len(parts) - 1))
                    if r == 1 << 30:
                        break
                    parts[k:k + 2] = [parts[k] + parts[k + 1]]
                ids.extend(vocab[p] for p in parts)
        return ids

    return encode


def fd_texts() -> list:
    import numpy as np

    rng = np.random.default_rng(SEED)
    return ["".join(FD_WORDS[int(i)] + (" " if rng.random() < 0.6 else "")
                    for i in rng.integers(0, len(FD_WORDS),
                                          size=int(rng.integers(1, 24))))
            for _ in range(FD_TEXTS)]


def fd_chat() -> list:
    """The two-turn chat of phase 3c as messages: turn 1's user text, an
    answer, turn two's question."""
    head = "Turn one of a chat about paged attention on one card. "
    user1 = (head * (TURN1_TOKENS // len(head) + 1))[:TURN1_TOKENS - len("user: ")]
    return [{"role": "user", "content": user1},
            {"role": "assistant", "content": "Pages of sixty-four rows each, "
                                             "shared across turns."},
            {"role": "user", "content": ("And what about turn two? " * 5)
             [:TURN2_EXTRA - 7]}]


def fd_llama3(messages: list) -> str:
    """The llama3 family's templates rendered by hand: each message's
    header, content and <|eot_id|>, joined by "\\n", inside the chat
    template."""
    body = "\n".join(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                     f"{m['content']}<|eot_id|>" for m in messages)
    return ("<|begin_of_text|>" + body
            + "<|start_header_id|>assistant<|end_header_id|>\n\n")


def fd_cold(eng):
    """Forget every row the engine could reuse: the device tier
    (forget_retained) and the host tier its eviction fills (the offloads
    waited for, then the store emptied)."""
    on_engine_thread(eng, lambda: forget_retained(eng))
    if eng._hstore is not None:
        eng._offloader.join()
        eng._hstore.clear()


def front_door_phase(card: str) -> dict:
    """Phase 3m (module doc): the JAX server's front door on the port."""
    import re
    import statistics

    import torch

    from localai_tpu_torch import cli
    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.api.chatflow import build_chat_prompt
    from localai_tpu_torch.engine.tokenizer import load_tokenizer
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    tag = "[front_door]"
    t0 = time.monotonic()
    vocab, merges = fd_vocab()
    models = fd_write(vocab, merges)
    ref = fd_reference(vocab, merges)
    mdir = os.path.join(models, FD_MODEL)
    t_tok = time.monotonic()
    tok = load_tokenizer(mdir)
    load_tok_s = time.monotonic() - t_tok
    log(f"{tag} wrote {len(vocab)} entries ({len(merges)} merges) in "
        f"{t_tok - t0:.1f} s; the port's tokenizer loads them in "
        f"{load_tok_s:.2f} s")
    texts = fd_texts()
    for text in texts:
        got = tok.encode(text)
        if got != ref(text):
            raise AssertionError(f"{tag} encode of {text!r}: {got} vs the "
                                 f"reference {ref(text)}")
        back = tok.decode(tok.encode(text, add_special_tokens=False),
                          skip_special_tokens=False)
        if back != text:
            raise AssertionError(f"{tag} decode gave {back!r} for {text!r}")
    n_merged = sum(len(ref(t)) < len(t.encode("utf-8")) + 1 for t in texts)
    log(f"{tag} encode == the naive reference on {len(texts)} texts "
        f"({n_merged} of them merged below one token per byte); decode "
        f"gives each back")

    # host costs on the engine's request path: the 3c chat, cold and warm
    chat = fd_chat()
    cold_tok = load_tokenizer(mdir)
    prompt = fd_llama3(chat)
    t = time.perf_counter()
    ids_cold = cold_tok.encode(prompt)
    cold_ms = (time.perf_counter() - t) * 1e3
    warm = []
    for _ in range(10):
        t = time.perf_counter()
        ids = cold_tok.encode(prompt)
        warm.append((time.perf_counter() - t) * 1e3)
    warm_ms = statistics.median(warm)
    assert ids == ids_cold == ref(prompt)

    args = cli.build_parser().parse_args(
        ["run", "--models-path", models, "--device", DEV,
         "--load-to-memory", FD_NAME])
    t_load = time.monotonic()
    app = cli.build_app(args)
    load_s = time.monotonic() - t_load
    lm = app.models[FD_NAME]
    eng = lm.engine
    mc = app.caps.configs[FD_NAME]
    renders = []
    for _ in range(20):
        t = time.perf_counter()
        rendered = build_chat_prompt(mc, chat)[0]
        renders.append((time.perf_counter() - t) * 1e3)
    if rendered != prompt:
        raise AssertionError(f"{tag} the guessed llama3 templates rendered "
                             f"{rendered[:200]!r}...")
    render_ms = statistics.median(renders)
    server = make_server(app, "127.0.0.1", 0)
    plain = App({FD_MODEL: lm})           # run --model over the same engine
    server2 = make_server(plain, "127.0.0.1", 0)
    for s in (server, server2):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    base2 = f"http://127.0.0.1:{server2.server_address[1]}"
    hello = vocab["Ġhello"]
    try:
        models_seen = http_json(base + "/v1/models")["data"]
        assert [(m["id"], m["ready"]) for m in models_seen] == [(FD_NAME, True)]
        m0 = eng.metrics()
        torch.cuda.synchronize()
        reset_launches()
        msgs = chat[:2] + [{"role": "user", "content": "Say hello."}]
        want_prompt = fd_llama3(msgs)
        toks = http_json(base + "/v1/tokenize",
                         {"model": FD_NAME, "content": want_prompt})["tokens"]
        if (toks != ref(want_prompt) or toks[:2] != [FD_BOS, FD_BOS]
                or toks.count(FD_HEADER) != len(msgs) + 1
                or toks.count(FD_END_HEADER) != len(msgs) + 1
                or toks.count(FD_EOT) != len(msgs)):
            raise AssertionError(f"{tag} /v1/tokenize: {toks[:8]}...")
        forced = {"temperature": 0, "max_tokens": 8, "ignore_eos": True,
                  "logit_bias": {str(hello): 100}}
        chunks, _t1, _t2 = http_stream(base + "/v1/chat/completions",
                                       {"model": FD_NAME, "messages": msgs,
                                        "stream": True, **forced})
        raw = "".join(c["choices"][0]["delta"].get("content") or ""
                      for c in chunks)
        if chunks[-1]["usage"]["prompt_tokens"] != len(toks) or not \
                raw.startswith(" hello"):
            raise AssertionError(f"{tag} forced stream: {raw!r}, "
                                 f"{chunks[-1]['usage']}")

        def finetune(text):                 # the config's rules, by hand
            return re.sub("l+", "", text).removeprefix(" ").strip()

        body = http_json(base + "/v1/chat/completions",
                         {"model": FD_NAME, "messages": msgs, **forced})
        got = body["choices"][0]["message"]["content"]
        if got != finetune(raw) or got == raw:
            raise AssertionError(f"{tag} cutstrings / trimspace: {got!r} from "
                                 f"{raw!r}")
        echo = http_json(base + "/v1/chat/completions",
                         {"model": FD_NAME, "messages": msgs, "echo": True,
                          **forced})["choices"][0]["message"]["content"]
        if echo != finetune(want_prompt + raw):
            raise AssertionError(f"{tag} echo: {echo[:300]!r}")
        eot, _a, _b = http_stream(base + "/v1/chat/completions",
                                  {"model": FD_NAME, "messages": msgs,
                                   "stream": True, "temperature": 0,
                                   "logit_bias": {str(FD_EOT): 100}})
        if (eot[-1]["choices"][0]["finish_reason"] != "stop" or any(
                c["choices"][0]["delta"].get("content") for c in eot)):
            raise AssertionError(f"{tag} the <|eot_id|> stream: {eot}")
        comp = http_json(base + "/v1/completions",
                         {"model": FD_NAME, "prompt": "The capital of France is",
                          "max_tokens": 8, "ignore_eos": True})
        edit = http_json(base + "/v1/edits",
                         {"model": FD_NAME, "instruction": "Fix the spelling",
                          "input": "teh cat sat", "max_tokens": 8,
                          "ignore_eos": True})
        if (comp["usage"]["completion_tokens"] != 8 or edit["object"] != "edit"
                or edit["usage"]["completion_tokens"] != 8):
            raise AssertionError(f"{tag} completion / edit: {comp} {edit}")
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        m1 = eng.metrics()
        pk = {k: m1["packed_prefill"][k] - m0["packed_prefill"][k]
              for k in ("dispatches", "tokens")}
        dec = {k: m1["decode"][k] - m0["decode"][k]
               for k in ("steps", "spec_rounds")}
        n_layers = LLAMA31_8B["num_hidden_layers"]
        if (launches["paged_decode_attention"] != n_layers * dec["steps"]
                or launches["ragged_prefill_attention"]
                != n_layers * (pk["dispatches"] + dec["spec_rounds"])
                or not launches["paged_decode_attention"]
                or not launches["ragged_prefill_attention"]):
            raise AssertionError(f"{tag} launches {launches} over {dec} and "
                                 f"{pk}")

        # TTFT of the 3c chat: the YAML path (template, encode, config)
        # against its rendered text through run --model (the same ids),
        # on the same engine, its reusable rows forgotten before each
        body_yaml = {"model": FD_NAME, "messages": chat, "stream": True,
                     **forced, "max_tokens": 4}
        body_plain = {"model": FD_MODEL, "prompt": prompt, "stream": True,
                      **forced, "max_tokens": 4}
        ttft = {"yaml": [], "model": []}
        for way in ("yaml", "model", "model", "yaml"):
            fd_cold(eng)
            t = time.monotonic()
            got_chunks, t_first, _ = http_stream(
                (base + "/v1/chat/completions") if way == "yaml"
                else (base2 + "/v1/completions"),
                body_yaml if way == "yaml" else body_plain)
            ttft[way].append(round((t_first - t) * 1e3, 3))
            if got_chunks[-1]["usage"]["prompt_tokens"] != len(ids):
                raise AssertionError(f"{tag} {way}: {got_chunks[-1]['usage']} "
                                     f"vs {len(ids)} ids")
    finally:
        for s in (server, server2):
            s.shutdown()
            s.server_close()
        app.shutdown()
        del lm, eng, app, plain
        gc.collect()
        torch.cuda.empty_cache()
    out = {"load_s": round(load_s, 2), "tokenizer_load_s": round(load_tok_s, 3),
           "chat_tokens": len(ids), "chat_bytes": len(prompt.encode("utf-8")),
           "encode_cold_ms": round(cold_ms, 3), "encode_warm_ms": round(warm_ms, 3),
           "encode_tok_s_cold": round(len(ids) / cold_ms * 1e3, 1),
           "encode_tok_s_warm": round(len(ids) / warm_ms * 1e3, 1),
           "render_ms": round(render_ms, 4), "ttft_ms": ttft,
           "texts": len(texts), "launches": {k: v for k, v in launches.items() if v},
           "decode": dec, "packed": pk, "card": card}
    log(f"{tag} {card}: the 3c chat ({len(ids)} tokens, "
        f"{out['chat_bytes']} bytes) encoded cold {cold_ms:.3f} ms, warm "
        f"{warm_ms:.3f} ms ({out['encode_tok_s_cold']:.0f} / "
        f"{out['encode_tok_s_warm']:.0f} tokens/s); templates rendered in "
        f"{render_ms:.4f} ms; loaded through the YAML in {load_s:.1f} s")
    log(f"{tag} {card}: TTFT of the 3c chat, YAML path {ttft['yaml']} ms vs "
        f"the same ids through run --model {ttft['model']} ms (order yaml, "
        f"model, model, yaml)")
    log(f"{tag} launches {json.dumps(out['launches'])} over {dec} and {pk}")
    return out


# ---------- phase 3n: GGUF checkpoints, yarn rope, LoRA ----------

GGUF_DIR = os.path.join(ROOT, "build", "chip_smoke", "gguf-1b")
GGUF_FILE = "llama-3.2-1b-q8_0.gguf"
GGUF_NAME = "llama-3.2-1b-gguf"
GGUF_YARN = (4.0, 8192)         # rope scaling factor, original context
GGUF_CONTEXT = 4096             # the 3n engines' max_context
GGUF_TTFT_PROMPT = 512          # (c) prompt tokens of the TTFT requests
GGUF_TTFT_RUNS = 3
GGUF_DECODE_TOKENS = 128        # (c) max_tokens of each of the 8 decode requests
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_DIR = os.path.join(ROOT, "build", "chip_smoke", "lora-1b")
_GGUF: dict = {}                # the written checkpoint (gguf_1b)


def gguf_1b() -> dict:
    """Phase 3n's GGUF checkpoint, written under the git-ignored build/ at
    its first use (phase 3k loads it as its draft): Llama-3.2-1B's
    published widths (LLAMA32_1B), random weights drawn on the card from
    SEED + 1 (normal / sqrt(fan_in) per projection, ones for the norms),
    the matmuls and the tied embedding Q8_0, the norms F32, no
    output.weight (tied), yarn rope scaling (factor 4 over an original
    context of 8192) and phase 3m's 128,256-entry byte-level BPE vocabulary
    with its merges as tokenizer metadata. Returns {"dir", "path",
    "draw_s", "write_s", "bytes"}."""
    if _GGUF:
        return _GGUF
    import math

    import numpy as np
    import torch

    from localai_tpu_torch.engine import gguf

    c = LLAMA32_1B
    D, F, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    H, KV, hd, V = (c["num_attention_heads"], c["num_key_value_heads"],
                    c["head_dim"], c["vocab_size"])
    os.makedirs(GGUF_DIR, exist_ok=True)
    path = os.path.join(GGUF_DIR, GGUF_FILE)
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)

    def draw(out, inn):
        """[out, in] (the GGUF file's row-major order), fan_in = in."""
        return (torch.randn((out, inn), generator=gen, device=DEV)
                / math.sqrt(inn)).cpu().numpy()

    ones = np.ones(D, np.float32)
    tensors = {"token_embd.weight": draw(V, D)}
    for i in range(L):
        p = f"blk.{i}."
        tensors.update({
            p + "attn_norm.weight": ones, p + "attn_q.weight": draw(H * hd, D),
            p + "attn_k.weight": draw(KV * hd, D), p + "attn_v.weight": draw(KV * hd, D),
            p + "attn_output.weight": draw(D, H * hd), p + "ffn_norm.weight": ones,
            p + "ffn_gate.weight": draw(F, D), p + "ffn_up.weight": draw(F, D),
            p + "ffn_down.weight": draw(D, F)})
    tensors["output_norm.weight"] = ones
    vocab, merges = fd_vocab()
    tokens = [""] * V
    for s, i in vocab.items():
        tokens[i] = s
    md = {"general.architecture": "llama", "general.name": GGUF_NAME,
          "llama.block_count": L, "llama.context_length": c["max_position_embeddings"],
          "llama.embedding_length": D, "llama.feed_forward_length": F,
          "llama.attention.head_count": H, "llama.attention.head_count_kv": KV,
          "llama.rope.dimension_count": hd, "llama.rope.freq_base": c["rope_theta"],
          "llama.attention.layer_norm_rms_epsilon": c["rms_norm_eps"],
          "llama.rope.scaling.type": "yarn",
          "llama.rope.scaling.factor": GGUF_YARN[0],
          "llama.rope.scaling.original_context_length": GGUF_YARN[1],
          "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.token_type": [3 if i >= 128000 else 1 for i in range(V)],
          "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
          "tokenizer.ggml.bos_token_id": FD_BOS, "tokenizer.ggml.eos_token_id": FD_EOT,
          "tokenizer.ggml.add_bos_token": True}
    types = {n: gguf.GGML_Q8_0 for n, a in tensors.items() if a.ndim == 2}
    t1 = time.monotonic()
    gguf.write_gguf(path, md, tensors, types)
    del tensors
    gc.collect()
    _GGUF.update(dir=GGUF_DIR, path=path, draw_s=t1 - t0,
                 write_s=time.monotonic() - t1, bytes=os.path.getsize(path))
    log(f"[gguf] wrote {path}: Llama-3.2-1B widths, Q8_0 matmuls and tied "
        f"embedding, F32 norms, yarn x{GGUF_YARN[0]:g} over {GGUF_YARN[1]}, a "
        f"{V}-entry BPE vocabulary; {_GGUF['bytes'] / 1e9:.3f} GB; weights drawn "
        f"in {_GGUF['draw_s']:.1f} s, tokenizer + encode + write "
        f"{_GGUF['write_s']:.1f} s")
    return _GGUF


def gguf_config(dtype):
    """The LlamaConfig the 3n checkpoint was written for, built here from
    LLAMA32_1B with yarn in place of its llama3 scaling."""
    from localai_tpu_torch.models.llama import LlamaConfig

    hf = dict(LLAMA32_1B, rope_scaling={
        "rope_type": "yarn", "factor": GGUF_YARN[0],
        "original_max_position_embeddings": GGUF_YARN[1]})
    return LlamaConfig.from_hf_config(hf, dtype=dtype)


def write_safetensors(path: str, tensors: dict):
    """A float32 .safetensors file (the 8-byte header length, the JSON
    header, the raw tensors), written here: the card's machine has no
    safetensors package."""
    import struct

    import numpy as np

    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        b = np.ascontiguousarray(a, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def write_lora_1b() -> str:
    """A rank-16 PEFT adapter on q_proj and v_proj of every layer of the 1B
    (adapter_config.json + adapter_model.safetensors under the git-ignored
    build/), A ~ N(0, 1/in), B ~ N(0, 0.05^2), drawn from SEED + 2."""
    import numpy as np

    c = LLAMA32_1B
    D, L = c["hidden_size"], c["num_hidden_layers"]
    dims = {"q_proj": c["num_attention_heads"] * c["head_dim"],
            "v_proj": c["num_key_value_heads"] * c["head_dim"]}
    rng = np.random.default_rng(SEED + 2)
    os.makedirs(LORA_DIR, exist_ok=True)
    with open(os.path.join(LORA_DIR, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA, "peft_type": "LORA",
                   "target_modules": list(dims)}, f)
    t = {}
    for i in range(L):
        for m, out in dims.items():
            pre = f"base_model.model.model.layers.{i}.self_attn.{m}"
            t[pre + ".lora_A.weight"] = (rng.standard_normal((LORA_RANK, D))
                                         / np.sqrt(D)).astype(np.float32)
            t[pre + ".lora_B.weight"] = (rng.standard_normal((out, LORA_RANK))
                                         * 0.05).astype(np.float32)
    write_safetensors(os.path.join(LORA_DIR, "adapter_model.safetensors"), t)
    return LORA_DIR


def first_token_logits(eng, ids: list):
    """The first-token logits (float32 [V], on the card) of a greedy
    request over ``ids`` (one pack: <= prefill_chunk tokens, nothing
    reused), read off the pack graph's logits as phase 3c reads them."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.prefill_graph import n_finals
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    box = {}
    run_pack = eng._prefill_pack

    def probe(bucket, continued, host, run_pack=run_pack):
        out = run_pack(bucket, continued, host)
        if n_finals(host, bucket, eng.ecfg.num_slots) and "logits" not in box:
            box["logits"] = eng._pgraph.logits[0].float().clone()
        return out

    on_engine_thread(eng, lambda: forget_retained(eng))
    eng._prefill_pack = probe
    try:
        out = eng.submit(GenRequest(prompt_ids=list(ids), max_new_tokens=1,
                                    params=SamplingParamsHost(temperature=0.0)))
        while (ev := out.get(timeout=300)) is not None:
            if ev.error:
                raise AssertionError(f"[gguf] first-token probe: {ev.error}")
    finally:
        del eng._prefill_pack
    return box["logits"]


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def gguf_serving(lm, tag: str, rng) -> dict:
    """(c) on a loaded 3n engine, speculation off: TTFT of GGUF_TTFT_PROMPT-
    token prompts alone (each new, nothing reused; median of
    GGUF_TTFT_RUNS after a warm-up), then 8 requests x GGUF_DECODE_TOKENS
    greedy tokens together: decode ms/step (the engine's decode seconds
    over its steps: host wall, sync included). Launch counters zeroed
    before, read after; K1 = layers x steps and K2 = layers x packs."""
    import statistics

    import torch

    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost
    from localai_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    eng = lm.engine
    pin_speculation(eng, False)
    V = lm.cfg.vocab_size

    def run(ids, n):
        t0, t_first = time.monotonic(), None
        out = eng.submit(GenRequest(prompt_ids=ids, max_new_tokens=n,
                                    ignore_eos=True,
                                    params=SamplingParamsHost(temperature=0.0)))
        got = 0
        while (ev := out.get(timeout=600)) is not None:
            if ev.error:
                raise AssertionError(f"{tag} {ev.error}")
            t_first = t_first or time.monotonic()
            got += len(ev.token_ids or [ev.token_id])
        if got != n:
            raise AssertionError(f"{tag} {got} tokens of {n}")
        return (t_first - t0) * 1e3

    run(rng.integers(1000, 100000, 64).tolist(), 4)           # warm-up
    torch.cuda.synchronize()
    m0 = eng.metrics()
    reset_launches()
    ttft = [run(rng.integers(1000, 100000, GGUF_TTFT_PROMPT).tolist(), 1)
            for _ in range(GGUF_TTFT_RUNS)]
    mid = eng.metrics()
    outs = [eng.submit(GenRequest(
        prompt_ids=rng.integers(1000, V - 300, 64).tolist(),
        max_new_tokens=GGUF_DECODE_TOKENS, ignore_eos=True,
        params=SamplingParamsHost(temperature=0.0))) for _ in range(S_SLOTS)]
    for o in outs:
        n = 0
        while (ev := o.get(timeout=600)) is not None:
            if ev.error:
                raise AssertionError(f"{tag} {ev.error}")
            n += len(ev.token_ids or [ev.token_id])
        if n != GGUF_DECODE_TOKENS:
            raise AssertionError(f"{tag} decode request: {n} tokens")
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    m1 = eng.metrics()
    dec = {k: m1["decode"][k] - mid["decode"][k] for k in ("steps", "seconds")}
    steps = m1["decode"]["steps"] - m0["decode"]["steps"]
    packs = m1["packed_prefill"]["dispatches"] - m0["packed_prefill"]["dispatches"]
    L = lm.cfg.num_layers
    k1 = launches.get("paged_decode_attention", 0)
    k2 = launches.get("ragged_prefill_attention", 0)
    if k1 != L * steps or k2 != L * packs or not k1 or not k2:
        raise AssertionError(f"{tag} launches {launches}: K1 {k1} (expected {L} x "
                             f"{steps} steps), K2 {k2} (expected {L} x {packs} packs)")
    pin_speculation(eng, True)
    return {"ttft_ms": [round(t, 3) for t in ttft],
            "ttft_median_ms": round(statistics.median(ttft), 3),
            "decode_ms_per_step": round(dec["seconds"] / max(1, dec["steps"]) * 1e3, 3),
            "decode_steps": dec["steps"], "launches": launches,
            "counts": {"steps": steps, "packs": packs}}


def gguf_phase(card: str) -> dict:
    """Phase 3n (module doc): the 1B GGUF checkpoint through load_model,
    bf16 and quantization int8, its leaves, logits and yarn against
    references on the card, TTFT and decode, and a LoRA adapter merged at
    load. The 8B target with this checkpoint as draft_model is phase 3k."""
    import dataclasses

    import numpy as np
    import torch

    from localai_tpu_torch.backend import runner
    from localai_tpu_torch.engine import gguf, weights
    from localai_tpu_torch.engine.engine import Engine
    from localai_tpu_torch.engine.gguf_tokenizer import GGUFTokenizer
    from localai_tpu_torch.engine.lora import LoraAdapter
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.quant import quantize_weight

    tag = "[gguf]"
    g = gguf_1b()
    knobs = dict(num_slots=S_SLOTS, context_size=GGUF_CONTEXT, dtype="bfloat16",
                 device=DEV, prefill_chunk=512, kv_page_size=PG, decode_burst=16)
    host = {"s": 0.0}
    leaves_of = gguf.iter_llama_tensors

    def timed_leaves(gf, cfg, dtype=np.float16):
        it = leaves_of(gf, cfg, dtype)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                host["s"] += time.perf_counter() - t
            yield item

    def load(**kw):
        host["s"] = 0.0
        gc.collect()
        torch.cuda.empty_cache()
        gb0 = torch.cuda.memory_allocated() / 1e9
        gguf.iter_llama_tensors = timed_leaves
        t0 = time.monotonic()
        try:
            lm = runner.load_model(GGUF_DIR, GGUF_NAME, **knobs, **kw)
        finally:
            gguf.iter_llama_tensors = leaves_of
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        return lm, {"load_s": round(load_s, 2), "host_dequant_s": round(host["s"], 2),
                    "host_dequant_share": round(host["s"] / load_s, 3),
                    "weights_gb": round(param_bytes(lm.engine.params) / 1e9, 3),
                    "allocated_gb": round(torch.cuda.memory_allocated() / 1e9, 3),
                    "before_gb": round(gb0, 3)}

    out = {"file": {k: (round(v, 2) if isinstance(v, float) else v)
                    for k, v in g.items() if k != "dir"}}
    rng = np.random.default_rng(SEED + 23)
    probe = rng.integers(1000, 100000, GGUF_TTFT_PROMPT).tolist()
    launches = {}
    # (a) bf16: config, tokenizer and leaves from the file
    lm, mem = load()
    try:
        cfg = lm.cfg
        want = gguf_config(torch.bfloat16)
        diff = {f.name: (getattr(cfg, f.name), getattr(want, f.name))
                for f in dataclasses.fields(cfg)
                if not (getattr(cfg, f.name) == getattr(want, f.name)
                        or isinstance(getattr(want, f.name), float)
                        and abs(getattr(cfg, f.name) - getattr(want, f.name))
                        <= 1e-6 * abs(getattr(want, f.name)))}
        tok = lm.tokenizer
        text = "The card reads the GGUF file's tokenizer: 128,256 pieces."
        if (diff or not isinstance(tok, GGUFTokenizer) or tok.vocab_size != cfg.vocab_size
                or tok.decode(tok.encode(text)) != text or tok.eos_token_id != FD_EOT):
            raise AssertionError(f"{tag} config from the file differs {diff}, or the "
                                 f"tokenizer: {type(tok).__name__} "
                                 f"{getattr(tok, 'vocab_size', None)}")
        # the card's leaves against the port's numpy dequantization, cast
        t0 = time.monotonic()
        host_leaves, bad = {}, []
        for path, arr in leaves_of(gguf.open_gguf(g["path"]), cfg):
            node = lm.engine.params
            for k in path:
                node = node[k]
            ref = torch.from_numpy(arr).to(DEV).to(torch.bfloat16)
            if not torch.equal(node.view(torch.int16), ref.view(torch.int16)):
                bad.append(path)
            host_leaves[path] = arr
        check_s = time.monotonic() - t0
        if bad:
            raise AssertionError(f"{tag} leaves not bit-equal to the numpy "
                                 f"dequantization cast to bf16: {bad}")
        # an engine over the same arrays handed over in memory
        params = weights._assemble(((p, torch.from_numpy(a)) for p, a in
                                    host_leaves.items()), torch.device(DEV),
                                   torch.bfloat16)
        del host_leaves
        mem_eng = Engine(want, params, tok, dataclasses.replace(lm.engine.ecfg),
                         device=DEV).start()
        try:
            l_mem = first_token_logits(mem_eng, probe)
        finally:
            mem_eng.shutdown()
            del mem_eng, params
            gc.collect()
            torch.cuda.empty_cache()
        l_file = first_token_logits(lm.engine, probe)
        err_mem = rel_l2(l_file, l_mem)
        # the captured pack graph's yarn (mscale and inv_freq) against an
        # eager forward, and against the same forward without yarn
        def eager(c):
            N = len(probe)
            ck, cv = llama.init_cache(c, 1, GGUF_TTFT_PROMPT, 0, device=DEV)
            t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt, device=DEV)  # noqa: E731
            return llama.ragged_prefill(
                lm.engine.params, c, t(probe, torch.int64), t(list(range(N))),
                t([0]), t([0]), t([0]), t([N]), t([0] * N), ck, cv,
                continued=False)[0].float()
        err_yarn = rel_l2(l_file, eager(cfg))
        err_none = rel_l2(l_file, eager(dataclasses.replace(cfg, rope_scaling_type="none")))
        if (not err_mem <= PREFIX_LOGITS_RTOL or not err_yarn <= PREFIX_LOGITS_RTOL
                or not err_none > 2 * err_yarn or not bool(torch.isfinite(l_file).all())):
            raise AssertionError(f"{tag} first-token logits rel L2: file vs memory "
                                 f"{err_mem:.3e}, graph vs eager yarn {err_yarn:.3e} "
                                 f"(tol {PREFIX_LOGITS_RTOL}), vs eager without yarn "
                                 f"{err_none:.3e} (must exceed twice the yarn one)")
        out["bf16"] = {**mem, "leaf_check_s": round(check_s, 2),
                       "logits_rel_l2_vs_memory": err_mem,
                       "logits_rel_l2_vs_eager_yarn": err_yarn,
                       "logits_rel_l2_vs_eager_no_yarn": err_none}
        out["bf16"].update(gguf_serving(lm, f"{tag} bf16", rng))
        launches["bf16"] = out["bf16"].pop("launches")
        base_logits = l_file
    finally:
        lm.engine.shutdown()
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    # (b) quantization int8: W8 from the dequantized leaves
    lm, mem = load(quantization="int8")
    try:
        gf = gguf.open_gguf(g["path"])
        for name, fmt in (("wq", "blk.{i}.attn_q.weight"), ("w_down", "blk.{i}.ffn_down.weight")):
            for i in (0, cfg.num_layers - 1):
                arr = gf.tensor(fmt.format(i=i), np.float16)
                if name == "wq":
                    arr = gguf._unpermute(arr, cfg.num_heads)
                ref = quantize_weight(torch.from_numpy(np.ascontiguousarray(arr.T))
                                      .to(DEV).float())
                got = lm.engine.params["layers"][name]
                if not (torch.equal(got["q"][i], ref["q"])
                        and torch.equal(got["s"][i], ref["s"])):
                    raise AssertionError(f"{tag} int8 {name}[{i}] differs from "
                                         f"quantize_weight of the dequantized leaf")
        out["int8"] = {**mem}
        out["int8"].update(gguf_serving(lm, f"{tag} int8", rng))
        launches["int8"] = out["int8"].pop("launches")
        if not launches["int8"].get(W8):
            raise AssertionError(f"{tag} int8: W8 not launched {launches['int8']}")
    finally:
        lm.engine.shutdown()
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    # (d) LoRA merged at load (bf16)
    adir = write_lora_1b()
    lm, mem = load(lora_adapter=adir)
    try:
        ad = LoraAdapter(adir)
        gf = gguf.open_gguf(g["path"])
        worst = 0
        for name, fmt, heads in (("wq", "blk.{i}.attn_q.weight", cfg.num_heads),
                                 ("wv", "blk.{i}.attn_v.weight", 0)):
            module = {"wq": "q_proj", "wv": "v_proj"}[name]
            for i in range(cfg.num_layers):
                arr = gf.tensor(fmt.format(i=i), np.float16)
                if heads:
                    arr = gguf._unpermute(arr, heads)
                w = torch.from_numpy(np.ascontiguousarray(arr.T)).to(DEV).float()
                ab = ad.mats[(f"self_attn.{module}", i)]
                A = torch.from_numpy(ab["A"]).to(DEV)
                B = torch.from_numpy(ab["B"]).to(DEV)
                ref = (w + ad.scale * (B @ A).T).to(torch.bfloat16)
                got = lm.engine.params["layers"][name][i]
                ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
                worst = max(worst, int(ulps.max()))
        l_lora = first_token_logits(lm.engine, probe)
        moved = rel_l2(l_lora, base_logits)
        if worst > 1 or not moved > PREFIX_LOGITS_RTOL:
            raise AssertionError(f"{tag} LoRA: merged leaves {worst} bf16 ulps from "
                                 f"W + s B@A (at most 1); first-token logits moved "
                                 f"{moved:.3e} rel L2 from the base model's (must "
                                 f"exceed {PREFIX_LOGITS_RTOL})")
        out["lora"] = {**mem, "rank": LORA_RANK, "scale": ad.scale,
                       "max_ulps_vs_w_plus_sba": worst, "logits_moved_rel_l2": moved}
        out["lora"].update(gguf_serving(lm, f"{tag} lora", rng))
        launches["lora"] = out["lora"].pop("launches")
    finally:
        lm.engine.shutdown()
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    total = {}
    for per in launches.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    out["launches"] = total
    out["launches_by_engine"] = launches
    out["card"] = card
    b, q, lo = out["bf16"], out["int8"], out["lora"]
    log(f"{tag} {card}: bf16 load {b['load_s']:.1f} s (host dequantization "
        f"{b['host_dequant_s']:.1f} s, {b['host_dequant_share'] * 100:.0f}%), "
        f"weights {b['weights_gb']:.3f} GB, memory_allocated after load "
        f"{b['allocated_gb']:.3f} GB; leaves bit-equal to the numpy dequantization "
        f"cast to bf16; first-token logits rel L2 vs the in-memory engine "
        f"{b['logits_rel_l2_vs_memory']:.2e}, vs an eager forward with yarn "
        f"{b['logits_rel_l2_vs_eager_yarn']:.2e}, without {b['logits_rel_l2_vs_eager_no_yarn']:.2e}; "
        f"TTFT of a {GGUF_TTFT_PROMPT}-token prompt {b['ttft_ms']} ms; decode "
        f"{b['decode_ms_per_step']:.3f} ms/step at {S_SLOTS} slots")
    log(f"{tag} {card}: int8 load {q['load_s']:.1f} s (host dequantization "
        f"{q['host_dequant_s']:.1f} s), weights {q['weights_gb']:.3f} GB, allocated "
        f"{q['allocated_gb']:.3f} GB; TTFT {q['ttft_ms']} ms; decode "
        f"{q['decode_ms_per_step']:.3f} ms/step")
    log(f"{tag} {card}: LoRA rank {LORA_RANK} on q_proj / v_proj (scale "
        f"{lo['scale']:g}): load {lo['load_s']:.1f} s, merged leaves within "
        f"{lo['max_ulps_vs_w_plus_sba']} bf16 ulp of W + s B@A, first-token logits "
        f"moved {lo['logits_moved_rel_l2']:.3e} rel L2; TTFT {lo['ttft_ms']} ms; "
        f"decode {lo['decode_ms_per_step']:.3f} ms/step")
    log(f"{tag} launches over the three engines' requests {json.dumps(total)}")
    return out


# ---------- phase 4 ----------

def decode_cost(lengths, elt, cache_elt=None, scales=False, table=True):
    """(bytes, flops) of one decode attention call: committed K and V rows
    (plus their f32 scales), the new k/v, q and out, and the table or
    lengths, each read or written once."""
    cache_elt = cache_elt or elt
    rows = sum(lengths)
    S = len(lengths)
    nbytes = (2 * rows * KV * (HD * cache_elt + (4 if scales else 0))
              + S * (2 * KV * HD + 2 * KV * G * HD) * elt
              + S * ((MP if table else 0) + 1) * 4)
    flops = 4 * G * HD * KV * (rows + S)
    return nbytes, flops


def prefill_cost(N, segs, elt, cache_elt=None, scales=False):
    cache_elt = cache_elt or elt
    committed = sum(start for _s, start, _n in segs)
    nbytes = (2 * committed * KV * (HD * cache_elt + (4 if scales else 0))
              + N * (2 * KV * G * HD + 2 * KV * HD) * elt + S_SLOTS * (MP + 4) * 4)
    visible = sum(n * start + n * (n + 1) // 2 for _s, start, n in segs)
    flops = 4 * HD * KV * G * visible
    return nbytes, flops


def bound(nbytes, flops, peak):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def sdpa_decode_inputs(q, nk, nv, kf, vf, lens, lengths):
    """SDPA operands of a decode step over dense rows kf/vf [S, >=L, KV, hd]:
    the committed rows plus the current token, GQA heads repeated."""
    import torch

    S = q.shape[0]
    slots = torch.arange(S, device=DEV)
    Lmax = max(lengths) + 1
    k_lib = kf[:, :Lmax].clone()
    v_lib = vf[:, :Lmax].clone()
    k_lib[slots, lens.long()] = nk.to(k_lib.dtype)
    v_lib[slots, lens.long()] = nv.to(v_lib.dtype)
    k_lib = k_lib.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)   # [S, H, L, hd]
    v_lib = v_lib.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    idx = torch.arange(Lmax, device=DEV)
    mask = (idx[None, :] <= lens[:, None])[:, None, None, :]
    return q[:, :, None, :], k_lib, v_lib, mask


def sdpa_prefill_inputs(q, ck, cv, kc, vc):
    """SDPA operands of one continued segment: committed rows kc/vc then
    the pack's keys, causal over the pack."""
    import torch

    start, N = kc.shape[0], q.shape[0]
    k_all = torch.cat([kc, ck]).permute(1, 0, 2).repeat_interleave(G, dim=0)[None]
    v_all = torch.cat([vc, cv]).permute(1, 0, 2).repeat_interleave(G, dim=0)[None]
    kpos = torch.arange(start + N, device=DEV)
    mask = kpos[None, :] <= (start + torch.arange(N, device=DEV))[:, None]
    return q.permute(1, 0, 2)[None], k_all, v_all, mask


def kernel_report(launches, k5_launches, errs, shapes, card):
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops import kvcache
    from localai_tpu_torch.ops.decode_attention import (
        contig_decode_plain, decode_attention_append_contig,
        decode_attention_append_full, full_decode_plain)
    from localai_tpu_torch.ops.paged_attention import (
        SPLIT_ROWS, paged_decode_attention, paged_decode_attention_quant,
        paged_decode_plain, paged_decode_quant_plain)
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    dt, elt = torch.bfloat16, 2
    peak = PEAK_FLOPS["bfloat16"]
    rows, profiled = [], []

    def decode_lengths(config):
        # the four requests mid-burst (prompt + 16 rows), four idle slots
        sh = shapes[config]
        lengths = [n + 16 for n in sh["prompt_lens"]] + [sh["n_long"] + 16]
        return lengths + [0] * (S_SLOTS - len(lengths))

    def add(name, replaces, source, config, fn, plain, lib, cost, shape,
            kernel_n=None, split_k=True, **extra):
        errs[name] = max(errs.get(name, 0.0), check_close(
            f"{name} at the serving shape", fn(), plain(), "bfloat16"))
        profiled.append((name, fn, split_k))
        r = {"name": name, "route": "cuda",
             "source": f"localai_tpu_torch/ops/kernels/csrc/{source}",
             "replaces": replaces,
             "launches": launches[config][name] if kernel_n is None else kernel_n,
             "max_abs_err": errs[name],
             "ms": timed_ms(fn), "plain_ms": timed_ms(plain),
             "library_ms": timed_ms(lib), **bound(*cost, peak),
             "config": config, "shape": shape,
             "launches_by_config": {c: launches[c][name] for c in launches},
             **extra}
        if split_k is True:             # the split-K decode kernels
            r["split_rows"] = SPLIT_ROWS
        rows.append(r)

    # K1 / K3 at the paged / int8 serving decode shapes
    for config, quant in (("paged", False), ("int8", True)):
        lengths = decode_lengths(config)
        a = decode_inputs(lengths, dt, SEED, cache_dtype=torch.int8 if quant else None)
        slots = torch.arange(S_SLOTS, device=DEV)
        if quant:
            q, nk, nv, qk, sk, qv, sv, ptab, lens = a
            # the library call reads dequantized, pre-gathered bf16 rows
            kf = (kvcache.gather_pool_rows(qk, ptab, slots).float()
                  * kvcache.gather_pool_rows(sk, ptab, slots)[..., None]).to(dt)
            vf = (kvcache.gather_pool_rows(qv, ptab, slots).float()
                  * kvcache.gather_pool_rows(sv, ptab, slots)[..., None]).to(dt)
            fn = lambda a=a: paged_decode_attention_quant(*a, G)      # noqa: E731
            plain = lambda a=a: paged_decode_quant_plain(*a, G)     # noqa: E731
            name, src, rep = ("paged_decode_attention_quant", "paged_decode.cu",
                              "localai_tpu/ops/pallas/paged_attention.py:281")
            cost = decode_cost(lengths, elt, cache_elt=1, scales=True)
            lib_note = "SDPA on dequantized pre-gathered bf16 rows (2x K3's cache bytes)"
        else:
            q, nk, nv, pk, pv, ptab, lens = a
            kf = kvcache.gather_pool_rows(pk, ptab, slots)
            vf = kvcache.gather_pool_rows(pv, ptab, slots)
            fn = lambda a=a: paged_decode_attention(*a, G)            # noqa: E731
            plain = lambda a=a: paged_decode_plain(*a, G)           # noqa: E731
            name, src, rep = ("paged_decode_attention", "paged_decode.cu",
                              "localai_tpu/ops/pallas/paged_attention.py:154")
            cost = decode_cost(lengths, elt)
            lib_note = "SDPA on pre-gathered rows"
        lib_args = sdpa_decode_inputs(q, nk, nv, kf, vf, lens, lengths)
        add(name, rep, src, config, fn, plain,
            lambda la=lib_args: F.scaled_dot_product_attention(
                la[0], la[1], la[2], attn_mask=la[3]),
            cost, f"bf16 S={S_SLOTS} KV={KV} G={G} hd={HD} pg={PG} "
                  f"{'int8 pages ' if quant else ''}lengths={lengths}",
            library=lib_note)

    def fresh_prefill_row(errs):
        """K2 on a fresh 512-token pack (mp = 0: the cache is not read),
        the shape most of its serving launches take."""
        segs = [(0, 0, 512)]
        a, _kw, _real = prefill_inputs(512, segs, dt, SEED)
        fn = lambda: ragged_prefill_attention_paged(*a, G, continued=False)  # noqa: E731
        plain = lambda: ragged_prefill_plain(*a, G, continued=False)        # noqa: E731
        name = "ragged_prefill_attention"
        errs[name] = max(errs[name], check_close(
            f"{name} at a fresh 512-token pack", fn(), plain(), "bfloat16"))
        kpos = torch.arange(a[0].shape[0], device=DEV)
        la = (a[0].permute(1, 0, 2)[None],
              a[1].permute(1, 0, 2).repeat_interleave(G, dim=0)[None],
              a[2].permute(1, 0, 2).repeat_interleave(G, dim=0)[None],
              kpos[None, :] <= kpos[:, None])
        return {"ms": timed_ms(fn), "plain_ms": timed_ms(plain),
                "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                    la[0], la[1], la[2], attn_mask=la[3])),
                **bound(*prefill_cost(512, segs, elt), peak),
                "shape": f"bf16 N=512 KV={KV} G={G} hd={HD} fresh segs={segs}",
                "library": "SDPA, causal mask over the pack"}

    def verify_prefill_row(quant, errs):
        """K2 / K2-int8 at the spec round's verify shape: 8 segments of
        5 tokens (the current token and 4 proposals), each over 1024
        committed rows; the library call is one batched SDPA over each
        slot's committed rows and its 5 keys."""
        segs = [(s, 1024, 5) for s in range(S_SLOTS)]
        N = 5 * S_SLOTS
        a, kw, _real = prefill_inputs(N, segs, dt, SEED + 7,
                                      cache_dtype=torch.int8 if quant else None)
        q, ck, cv, pk, pv, ptab = a[:6]
        fn = lambda: ragged_prefill_attention_paged(*a, G, **kw, continued=True)  # noqa: E731
        plain = lambda: ragged_prefill_plain(*a, G, **kw, continued=True)        # noqa: E731
        name = "ragged_prefill_attention_int8" if quant else "ragged_prefill_attention"
        errs[name] = max(errs[name], check_close(
            f"{name} at the verify shape", fn(), plain(), "bfloat16"))
        slots = torch.arange(S_SLOTS, device=DEV)
        kc = kvcache.gather_pool_rows(pk, ptab, slots)[:, :1024]
        vc = kvcache.gather_pool_rows(pv, ptab, slots)[:, :1024]
        if quant:
            kc = (kc.float() * kvcache.gather_pool_rows(
                kw["scales_k"], ptab, slots)[:, :1024, :, None]).to(dt)
            vc = (vc.float() * kvcache.gather_pool_rows(
                kw["scales_v"], ptab, slots)[:, :1024, :, None]).to(dt)
        qb = q.reshape(S_SLOTS, 5, KV * G, HD).permute(0, 2, 1, 3)       # [B, H, 5, hd]
        kb = torch.cat([kc, ck.reshape(S_SLOTS, 5, KV, HD)], 1)          # [B, 1029, KV, hd]
        vb = torch.cat([vc, cv.reshape(S_SLOTS, 5, KV, HD)], 1)
        kb = kb.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        vb = vb.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        kpos = torch.arange(1029, device=DEV)
        mask = kpos[None, :] <= (1024 + torch.arange(5, device=DEV))[:, None]
        return {"ms": timed_ms(fn), "plain_ms": timed_ms(plain),
                "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=mask)),
                **bound(*prefill_cost(N, segs, elt, cache_elt=1 if quant else None,
                                      scales=quant), peak),
                "shape": f"bf16 N={N} KV={KV} G={G} hd={HD} pg={PG} "
                         f"{'int8 pages ' if quant else ''}verify segs={segs[:1]} x {S_SLOTS}",
                "library": "SDPA batched over the 8 slots, committed rows "
                           + ("dequantized to bf16 " if quant else "")
                           + "+ the 5 keys, causal over them"}

    # K2 / K2-int8 at the serving continued pack: the long prompt's 3rd
    # chunk (512 tokens over 1024 committed rows), one segment
    for config, quant in (("paged", False), ("int8", True)):
        segs = [(0, 1024, min(512, shapes[config]["n_long"] - 1024))]
        N = segs[0][2]
        a, kw, _real = prefill_inputs(N, segs, dt, SEED,
                                      cache_dtype=torch.int8 if quant else None)
        q2, ck2, cv2, pk2, pv2, ptab2 = a[:6]
        start = segs[0][1]
        zero = torch.zeros(1, device=DEV, dtype=torch.long)
        kc = kvcache.gather_pool_rows(pk2, ptab2, zero)[0, :start]
        vc = kvcache.gather_pool_rows(pv2, ptab2, zero)[0, :start]
        if quant:
            kc = (kc.float() * kvcache.gather_pool_rows(
                kw["scales_k"], ptab2, zero)[0, :start, :, None]).to(dt)
            vc = (vc.float() * kvcache.gather_pool_rows(
                kw["scales_v"], ptab2, zero)[0, :start, :, None]).to(dt)
        lib_args = sdpa_prefill_inputs(q2, ck2, cv2, kc, vc)
        name = "ragged_prefill_attention_int8" if quant else "ragged_prefill_attention"
        add(name, "localai_tpu/ops/pallas/ragged_prefill.py:251"
            + (" (int8 pages: the jnp op localai_tpu/ops/ragged_prefill.py:96-124)"
               if quant else ""),
            "ragged_prefill.cu", config,
            lambda a=a, kw=kw: ragged_prefill_attention_paged(*a, G, **kw,
                                                              continued=True),
            lambda a=a, kw=kw: ragged_prefill_plain(*a, G, **kw, continued=True),
            lambda la=lib_args: F.scaled_dot_product_attention(
                la[0], la[1], la[2], attn_mask=la[3]),
            prefill_cost(N, segs, elt, cache_elt=1 if quant else None, scales=quant),
            f"bf16 N={N} KV={KV} G={G} hd={HD} pg={PG} "
            f"{'int8 pages ' if quant else ''}segs={segs}", split_k=False,
            library="SDPA, causal mask over committed + pack keys"
                    + (" (dequantized bf16 committed rows)" if quant else ""))
        if not quant:
            rows[-1]["fresh"] = fresh_prefill_row(errs)
        rows[-1]["verify"] = verify_prefill_row(quant, errs)

    # K4 / K5 at the contiguous serving decode shape
    lengths = decode_lengths("contig")
    q, nk, nv, ck, cv, lens = contig_inputs(lengths, dt, SEED, layers=K5_LAYERS)
    li = K5_LAYER
    k4 = (q, nk, nv, ck[li, :S_SLOTS], cv[li, :S_SLOTS], lens)
    lib_args = sdpa_decode_inputs(q, nk, nv, k4[3], k4[4], lens, lengths)
    lib = lambda la=lib_args: F.scaled_dot_product_attention(     # noqa: E731
        la[0], la[1], la[2], attn_mask=la[3])
    shape = (f"bf16 S={S_SLOTS} KV={KV} G={G} hd={HD} C={C_MAX} "
             f"lengths={lengths}")
    cost = decode_cost(lengths, elt, table=False)
    add("decode_attention_append_contig",
        "localai_tpu/ops/pallas/decode_attention.py:157", "contig_decode.cu",
        "contig", lambda: decode_attention_append_contig(*k4, G),
        lambda: contig_decode_plain(*k4, G), lib, cost, shape,
        library="SDPA on the contiguous rows")
    from localai_tpu_torch.ops.kernels import LAUNCHES

    layer = torch.tensor([li], dtype=torch.int32, device=DEV)
    k5 = (q, nk, nv, ck, cv, lens, layer)
    n0 = LAUNCHES["decode_attention_append_full"]
    add("decode_attention_append_full",
        "localai_tpu/ops/pallas/decode_attention.py:134", "contig_decode.cu",
        "contig", lambda: decode_attention_append_full(*k5, G),
        lambda: full_decode_plain(*k5, G), lib, cost,
        shape + f" stacked L={K5_LAYERS} layer={li}",
        kernel_n=0, library="SDPA on the layer's contiguous rows",
        launches_from="phases 2 and 4: no serving path calls K5 (nor its TPU "
                      "kernel in the JAX package)")
    rows[-1]["launches"] = k5_launches + LAUNCHES["decode_attention_append_full"] - n0
    quant_rows(rows, profiled, add, errs, shapes, dt, elt, peak)
    # the draft path (phase 3k): each kernel at the 1B draft's shapes, and
    # its launches there; a row whose configuration ran 3k counts them in
    draft = draft_kernel_rows(errs)
    for r in rows:
        runs = {c: shapes[c]["draft"]["launches"].get(r["name"], 0)
                for c in shapes if shapes[c]["draft"]}
        if r["name"] in draft:
            r["draft"] = draft[r["name"]]
        r["launches_draft_path"] = runs
        r["launches"] += runs.get(r["config"], 0)
        # the grammar path (phase 3l): its launches by configuration
        gruns = {c: shapes[c]["grammar"]["launches"].get(r["name"], 0)
                 for c in shapes if shapes[c]["grammar"]}
        r["launches_grammar_path"] = gruns
        r["launches"] += gruns.get(r["config"], 0)
        # the front door (phase 3m): paged, loaded through a YAML file
        fruns = {c: shapes[c]["front_door"]["launches"].get(r["name"], 0)
                 for c in shapes if shapes[c].get("front_door")}
        r["launches_front_door_path"] = fruns
        r["launches"] += fruns.get(r["config"], 0)
        # the GGUF path (phase 3n): the 1B checkpoint's three engines (bf16
        # paged, int8 weights, LoRA); every row counts them in
        r["launches_gguf_path"] = shapes["paged"]["gguf"]["launches"].get(
            r["name"], 0)
        r["launches"] += r["launches_gguf_path"]
        r["max_abs_err"] = errs[r["name"]]

    # the CUDA kernels of one wrapper call, after every timing above (the
    # profiler's tracing stays out of the timed calls)
    for r, (name, fn, split_k) in zip(rows, profiled):
        per_call, kernel_names = kernels_per_call(fn, name)
        log(f"[kernels] {name}: one wrapper call ran {per_call} CUDA kernels "
            f"(torch.profiler): {kernel_names}")
        if split_k is True and per_call is not None and (
                per_call != 2 or not any("split_kernel" in n for n in kernel_names)
                or not any("combine_kernel" in n for n in kernel_names)):
            raise RuntimeError(f"{name}: expected one split_kernel and one combine "
                               f"kernel per call, the profiler saw {kernel_names}")
        if split_k == "wgmma":
            check_wgmma_call(name, r["tc_plan"], per_call, kernel_names)
        r["cuda_kernels_per_call"] = per_call
        for sub in ("lm_head", "wide"):
            if sub in r:
                n, names = kernels_per_call(r[sub].pop("fn"), f"{name} {sub}")
                log(f"[kernels] {name} {sub}: one wrapper call ran {n} CUDA "
                    f"kernels (torch.profiler): {names}")
                check_wgmma_call(f"{name} {sub}", r[sub]["tc_plan"], n, names)
                r[sub]["cuda_kernels_per_call"] = n

    n_layers = LLAMA31_8B["num_hidden_layers"]
    for r in rows:
        sh = shapes[r["config"]]
        if r["name"] in ("paged_decode_attention", "paged_decode_attention_quant",
                         "decode_attention_append_contig"):
            log(f"[kernels] {card}: {r['name']} share of a {r['config']} decode "
                f"step ~ {n_layers * r['ms'] / sh['step_ms'] * 100:.1f}% "
                f"({n_layers} layers x {r['ms']:.4f} ms / {sh['step_ms']:.2f} ms)")
        for x in (r, r.get("fresh"), r.get("verify"), r.get("lm_head"), r.get("wide"),
                  r.get("draft"), (r.get("draft") or {}).get("tied_lm_head"),
                  *(r.get("draft") or {}).get("shapes", {}).values()):
            if x:
                log(f"[kernels] {card}: {r['name']} {x['ms']:.4f} ms (plain "
                    f"{x['plain_ms']:.4f}, library {x['library_ms']:.4f}, bound "
                    f"{x['bound_ms']:.4f} by {x['bound_by']}) at {x['shape']}")
    return rows


def draft_kernel_rows(errs: dict) -> dict:
    """Phase 4 at the 1B draft's shapes, keyed by kernel (module doc): K1,
    K3 and K4 at KV 8, G 4, hd 64 over 8 slots x SPEC_PART_ROWS committed
    rows (phase 3k's round parts), K2 and K2-int8 at hd 64 on the draft's
    mirror of the long prompt's third chunk (512 tokens over 1024 rows),
    W8 at the 1B projections at M = 8 (a draft step of 8 slots) and the
    tied int8 table [128256, 2048] used transposed at M = 8 (the draft's
    unembed: dequantize into the scratch + torch.matmul). Each: kernel,
    plain and library ms (timed_ms), the bound, the parity error."""
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops import kvcache
    from localai_tpu_torch.ops.decode_attention import (
        contig_decode_plain, decode_attention_append_contig)
    from localai_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_quant, paged_decode_plain,
        paged_decode_quant_plain)
    from localai_tpu_torch.ops.quant import mat, quant_matmul, quant_matmul_plain
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged, ragged_prefill_plain)

    dt, elt, peak = torch.bfloat16, 2, PEAK_FLOPS["bfloat16"]
    out = {}

    def row(name, fn, plain, lib, cost, shape, library):
        errs[name] = max(errs.get(name, 0.0), check_close(
            f"{name} at the draft's shape {shape}", fn(), plain(), "bfloat16"))
        return {"ms": timed_ms(fn), "plain_ms": timed_ms(plain),
                "library_ms": timed_ms(lib), **bound(*cost, peak),
                "shape": shape, "library": library}

    def sdpa(la):
        return lambda: F.scaled_dot_product_attention(la[0], la[1], la[2],
                                                      attn_mask=la[3])

    with head_dim(DRAFT_HD):
        lengths = [SPEC_PART_ROWS] * S_SLOTS
        slots = torch.arange(S_SLOTS, device=DEV)
        shape = (f"bf16 S={S_SLOTS} KV={KV} G={G} hd={HD} pg={PG} "
                 f"lengths={SPEC_PART_ROWS} x {S_SLOTS}")
        a = decode_inputs(lengths, dt, SEED)
        q, nk, nv, pk, pv, ptab, lens = a
        la = sdpa_decode_inputs(q, nk, nv, kvcache.gather_pool_rows(pk, ptab, slots),
                                kvcache.gather_pool_rows(pv, ptab, slots), lens, lengths)
        out["paged_decode_attention"] = row(
            "paged_decode_attention", lambda: paged_decode_attention(*a, G),
            lambda: paged_decode_plain(*a, G), sdpa(la), decode_cost(lengths, elt),
            shape, "SDPA on pre-gathered rows")
        a3 = decode_inputs(lengths, dt, SEED, cache_dtype=torch.int8)
        q, nk, nv, qk, sk, qv, sv, ptab, lens = a3
        kf = (kvcache.gather_pool_rows(qk, ptab, slots).float()
              * kvcache.gather_pool_rows(sk, ptab, slots)[..., None]).to(dt)
        vf = (kvcache.gather_pool_rows(qv, ptab, slots).float()
              * kvcache.gather_pool_rows(sv, ptab, slots)[..., None]).to(dt)
        la3 = sdpa_decode_inputs(q, nk, nv, kf, vf, lens, lengths)
        out["paged_decode_attention_quant"] = row(
            "paged_decode_attention_quant",
            lambda: paged_decode_attention_quant(*a3, G),
            lambda: paged_decode_quant_plain(*a3, G), sdpa(la3),
            decode_cost(lengths, elt, cache_elt=1, scales=True),
            "int8 pages " + shape, "SDPA on dequantized pre-gathered bf16 rows")
        q, nk, nv, ck, cv, lens = contig_inputs(lengths, dt, SEED)
        k4 = (q, nk, nv, ck[0, :S_SLOTS], cv[0, :S_SLOTS], lens)
        la4 = sdpa_decode_inputs(q, nk, nv, k4[3], k4[4], lens, lengths)
        out["decode_attention_append_contig"] = row(
            "decode_attention_append_contig",
            lambda: decode_attention_append_contig(*k4, G),
            lambda: contig_decode_plain(*k4, G), sdpa(la4),
            decode_cost(lengths, elt, table=False),
            f"bf16 S={S_SLOTS} KV={KV} G={G} hd={HD} C={C_MAX} "
            f"lengths={SPEC_PART_ROWS} x {S_SLOTS}", "SDPA on the contiguous rows")
        del ck, cv
        segs = [(0, 1024, 512)]
        for quant in (False, True):
            a2, kw, _real = prefill_inputs(512, segs, dt, SEED,
                                           cache_dtype=torch.int8 if quant else None)
            q2, ck2, cv2, pk2, pv2, ptab2 = a2[:6]
            zero = torch.zeros(1, device=DEV, dtype=torch.long)
            kc = kvcache.gather_pool_rows(pk2, ptab2, zero)[0, :1024]
            vc = kvcache.gather_pool_rows(pv2, ptab2, zero)[0, :1024]
            if quant:
                kc = (kc.float() * kvcache.gather_pool_rows(
                    kw["scales_k"], ptab2, zero)[0, :1024, :, None]).to(dt)
                vc = (vc.float() * kvcache.gather_pool_rows(
                    kw["scales_v"], ptab2, zero)[0, :1024, :, None]).to(dt)
            name = ("ragged_prefill_attention_int8" if quant
                    else "ragged_prefill_attention")
            out[name] = row(
                name, lambda a2=a2, kw=kw: ragged_prefill_attention_paged(
                    *a2, G, **kw, continued=True),
                lambda a2=a2, kw=kw: ragged_prefill_plain(*a2, G, **kw, continued=True),
                sdpa(sdpa_prefill_inputs(q2, ck2, cv2, kc, vc)),
                prefill_cost(512, segs, elt, cache_elt=1 if quant else None,
                             scales=quant),
                f"bf16 N=512 KV={KV} G={G} hd={HD} pg={PG} "
                f"{'int8 pages ' if quant else ''}segs={segs}",
                "SDPA, causal mask over committed + pack keys")
    per = {}
    for shape_name, (K, N) in DRAFT_QUANT_SHAPES.items():
        leaf = quant_weight(K, N, 8, SEED + K + N)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        x = torch.randn((S_SLOTS, K), generator=gen, device=DEV).to(dt)
        dense = mat(leaf, dt)
        per[shape_name] = row(
            W8, lambda x=x, leaf=leaf: quant_matmul(x, leaf),
            lambda x=x, leaf=leaf: quant_matmul_plain(x, leaf),
            lambda x=x, dense=dense: torch.matmul(x, dense),
            (leaf["q"].numel() + leaf["s"].numel() * 4
             + (S_SLOTS * K + S_SLOTS * N) * elt, 2 * S_SLOTS * K * N),
            f"bf16 x [{S_SLOTS}, {K}] @ int8 1B {shape_name} [{K}, {N}]",
            "torch.matmul with the dense bf16 weight")
    K, V = LLAMA32_1B["hidden_size"], LLAMA32_1B["vocab_size"]
    table = quant_weight(V, K, 8, SEED)
    dense = mat(table, dt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x = torch.randn((S_SLOTS, K), generator=gen, device=DEV).to(dt)
    tied = row(W8, lambda: quant_matmul(x, table, transposed=True),
               lambda: quant_matmul_plain(x, table, transposed=True),
               lambda: torch.matmul(x, dense.T),
               (table["q"].numel() + table["s"].numel() * 4
                + (S_SLOTS * K + S_SLOTS * V) * elt, 2 * S_SLOTS * K * V),
               f"bf16 x [{S_SLOTS}, {K}] @ tied int8 table [{V}, {K}] transposed",
               "torch.matmul with the dense bf16 table, transposed")
    tied["route"] = ("dequantize the whole table into the bf16 scratch, then "
                     "torch.matmul (ops/quant.py: a transposed table)")
    out[W8] = {**per["w_gate_up"], "shapes": per, "tied_lm_head": tied}
    del table, dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def check_wgmma_call(name, plan, per_call, kernel_names):
    """A bf16 W8 / W4 call runs the tensor-core kernel once, plus the
    combine when its plan splits K, and nothing else: no library GEMM, no
    dequantize into a dense scratch."""
    if per_call is None:
        return
    want = 1 + (plan["n_split"] > 1)
    n_tc = sum("wgmma_kernel" in n for n in kernel_names)
    n_comb = sum("combine_kernel" in n for n in kernel_names)
    if per_call != want or n_tc != 1 or n_tc + n_comb != per_call:
        raise RuntimeError(f"{name}: expected one wgmma_kernel"
                           f"{' and one combine_kernel' if want == 2 else ''} per "
                           f"call (plan {plan}), the profiler saw {kernel_names}")


def quant_rows(rows, profiled, add, errs, shapes, dt, elt, peak):
    """W8's and W4's rows (module doc): w_gate at decode M = 8 through
    ``add``; lm_head at M = 8 and w_gate at M = 512 (the wide path) under
    "lm_head" and "wide"; under "per_step" every projection shape at M = 8
    summed over a decode step (32 layers + lm_head), kernel against the
    dense bf16 product."""
    import torch

    from localai_tpu_torch.ops.quant import (_sm_count, mat, quant_matmul,
                                             quant_matmul_plain, tc_plan)

    S = S_SLOTS
    sms = _sm_count(torch.device(DEV))

    def plan_of(K, N, M):
        tile, chunk, n_split = tc_plan(M, K, N, sms)
        return {"token_tile": tile, "k_chunk": chunk, "n_split": n_split}

    def case(K, N, M, bits):
        leaf = quant_weight(K, N, bits, SEED + K + N)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        x = torch.randn((M, K), generator=gen, device=DEV).to(dt)
        dense = mat(leaf, dt)            # the bf16 model's weight of this shape
        wbytes = leaf["q"].numel() + leaf["s"].numel() * 4
        return (lambda: quant_matmul(x, leaf), lambda: quant_matmul_plain(x, leaf),
                lambda: torch.matmul(x, dense),
                (wbytes + (M * K + M * N) * elt, 2 * M * K * N))

    def measure(name, K, N, M, bits):
        fn, plain, lib, cost = case(K, N, M, bits)
        errs[name] = max(errs[name], check_close(
            f"{name} K={K} N={N} M={M}", fn(), plain(), "bfloat16"))
        return {"ms": timed_ms(fn), "plain_ms": timed_ms(plain),
                "library_ms": timed_ms(lib), **bound(*cost, peak), "fn": fn,
                "shape": f"bf16 x [{M}, {K}] @ int{bits} [{K}, {N}]",
                "tc_plan": plan_of(K, N, M)}

    lib_note = ("torch.matmul with the dense bf16 weight of the same shape "
                "(the bf16 model's product; the port never calls it for a "
                "quantized weight)")
    n_layers = LLAMA31_8B["num_hidden_layers"]
    for name, config, bits in ((W8, "w8kv8", 8), (W4, "w4", 4)):
        K, N = QUANT_SHAPES["w_gate_up"]
        fn, plain, lib, cost = case(K, N, S, bits)
        add(name, "no pallas_call: XLA's fusion of localai_tpu/ops/quant.py:95 "
            "(mat) into the einsums of localai_tpu/models/llama.py:229-248, "
            ":326, :608", "quant_matmul.cu", config, fn, plain, lib, cost,
            f"bf16 x [{S}, {K}] @ int{bits} w_gate [{K}, {N}]"
            + (" g=128" if bits == 4 else ""), split_k="wgmma", library=lib_note,
            cuda_route="wgmma: the tensor-core kernel (bf16 x), int8 / int4 "
                       "tiles widened in shared memory",
            tc_plan=plan_of(K, N, S))
        r = rows[-1]
        r["lm_head"] = measure(name, *QUANT_SHAPES["lm_head"], S, bits)
        r["wide"] = measure(name, K, N, 512, bits)
        # a decode step's products: each shape once at M = 8 (the int4
        # configuration's lm_head is W8)
        per = {}
        for shape, (k, n) in QUANT_SHAPES.items():
            b = 8 if shape == "lm_head" else bits
            f, _p, lb, _c = case(k, n, S, b)
            per[shape] = {"ms": timed_ms(f), "library_ms": timed_ms(lb), "bits": b}
        step = lambda key: (n_layers * sum(PER_LAYER[k] * per[k][key] for k in PER_LAYER)
                            + per["lm_head"][key])
        r["per_step"] = {"shapes": per, "ms": step("ms"), "library_ms": step("library_ms"),
                         "decode_step_ms": shapes[config]["step_ms"]}
        log(f"[kernels] {name}: a {config} decode step's weight products "
            f"(M = {S}, {n_layers} layers + lm_head) take {step('ms'):.3f} ms of "
            f"kernel time; the same products on dense bf16 weights "
            f"{step('library_ms'):.3f} ms; the step {shapes[config]['step_ms']:.2f} "
            f"ms (host wall)")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main():
    t_main = time.monotonic()
    card = setup()
    from localai_tpu_torch.ops.kernels import LAUNCHES

    k5_before = LAUNCHES["decode_attention_append_full"]
    errs = parity()
    k5_launches = LAUNCHES["decode_attention_append_full"] - k5_before
    # after every engine's shutdown (phases 3-3j), a drained audit: 0
    # violations and 0 leaked pages in its whole life
    from localai_tpu_torch.engine.engine import Engine

    audits = []
    shutdown = Engine.shutdown

    def audited(self, shutdown=shutdown, audits=audits):
        shutdown(self)
        if self._kv_audit is not None:
            audits.append(self.kv_audit_sweep(drained=True))

    Engine.shutdown = audited
    launches, shapes = {}, {}
    for config, knobs, must, must_not in CONFIGS:
        launches[config], shapes[config] = serve(card, config, knobs, must,
                                                 must_not)
    # phase 3m: the paged configuration again, loaded through a YAML file
    shapes["paged"]["front_door"] = phase_timed("paged", front_door_phase,
                                                card)
    # phase 3n: the 1B GGUF checkpoint (bf16, int8, LoRA); 3k loaded it
    # as the draft
    shapes["paged"]["gguf"] = phase_timed("paged", gguf_phase, card)
    Engine.shutdown = shutdown
    bad = [a for a in audits if a["violations"] or a["leaked_pages"]]
    log(f"[obs] drained audits after shutdown: {len(audits)} paged engines, "
        f"{sum(a['checks'] for a in audits)} checks, {len(bad)} with violations "
        f"or leaked pages")
    if bad or not audits:
        raise AssertionError(f"[obs] drained audits: {bad}")
    rows = kernel_report(launches, k5_launches, errs, shapes, card)
    import torch

    print(json.dumps({"observability": {c: shapes[c]["obs"] for c in shapes},
                      "cost": shapes["paged"]["obs_cost"],
                      "drained_audits": len(audits), "card": card},
                     default=str), flush=True)

    print(json.dumps({"decode": {c: shapes[c]["decode"] for c in shapes},
                      "card": card}), flush=True)
    print(json.dumps({"prefix_reuse": {c: shapes[c]["prefix"] for c in shapes
                                       if shapes[c]["prefix"]},
                      "card": card}), flush=True)
    print(json.dumps({"prefill": {c: shapes[c]["prefill"] for c in shapes},
                      "card": card}), flush=True)
    print(json.dumps({"context_shift": {c: shapes[c]["shift"] for c in shapes
                                        if shapes[c]["shift"]},
                      "card": card}), flush=True)
    print(json.dumps({"pipeline": {c: shapes[c]["pipeline"] for c in shapes
                                   if shapes[c]["pipeline"]},
                      "card": card}), flush=True)
    print(json.dumps({"lifecycle": {c: shapes[c]["lifecycle"] for c in shapes
                                    if shapes[c]["lifecycle"]},
                      "card": card}), flush=True)
    print(json.dumps({"spec": {c: shapes[c]["spec"] for c in shapes
                               if shapes[c]["spec"]},
                      "serving": {c: shapes[c]["spec_serving"] for c in shapes},
                      "card": card}), flush=True)
    print(json.dumps({"draft": {c: shapes[c]["draft"] for c in shapes
                                if shapes[c]["draft"]},
                      "card": card}, default=str), flush=True)
    print(json.dumps({"grammar": {c: shapes[c]["grammar"] for c in shapes
                                  if shapes[c]["grammar"]},
                      "card": card}, default=str), flush=True)
    print(json.dumps({"front_door": shapes["paged"]["front_door"],
                      "card": card}), flush=True)
    print(json.dumps({"gguf": shapes["paged"]["gguf"], "card": card},
                     default=str), flush=True)
    print(json.dumps({"host_tier": {c: shapes[c]["host"] for c in shapes
                                    if shapes[c]["host"]},
                      "memory": {c: shapes[c]["memory"] for c in shapes},
                      "card": card}), flush=True)
    for c in shapes:
        p = shapes[c]["prefill"]
        tr = p["trace"].get("graph")
        log(f"[prefill] {card}: {c}: ms/pack graph vs eager "
            + ", ".join(f"{r['bucket']}{'c' if r['continued'] else 'f'} "
                        f"{r['graph_ms']:.2f}/{r['eager_ms']:.2f}"
                        for r in p["packs"].values())
            + f"; replayed {TRACED_PACK[0]}c pack busy "
            + (f"{tr['busy_share'] * 100:.1f}%" if tr else "not measured")
            + f"; capture {p['capture_s']:.2f} s, pool {p['pool_bytes'] / 1e6:.1f} MB")
    for c in shapes:
        d = shapes[c]["decode"]
        busy = {w: (f"{d[w]['trace']['busy_share'] * 100:.1f}%" if d[w]["trace"]
                    else "not measured") for w in ("graph", "eager")}
        log(f"[decode] {card}: {c}: graph {d['graph']['ms_per_step']:.3f} ms/step "
            f"(busy {busy['graph']}), full sampler {d['full']['ms_per_step']:.3f}, "
            f"vs eager {d['eager']['ms_per_step']:.3f} "
            f"(busy {busy['eager']}); capture {d['capture_s']:.2f} s, pool "
            f"{d['pool_bytes'] / 1e6:.1f} MB")
    log(f"[time] whole run {time.monotonic() - t_main:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
