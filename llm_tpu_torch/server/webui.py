"""(The port's own copy of llm_tpu/server/webui.py.) Minimal built-in web UI served at GET / (the analogue of the
reference's tools/server/webui, reduced to one dependency-free page that
talks to /v1/chat/completions with SSE streaming)."""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>llm-tpu server</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#10141a;color:#e6e6e6;
      display:flex;flex-direction:column;height:100vh}
 header{padding:10px 16px;background:#161b24;font-weight:600}
 #log{flex:1;overflow-y:auto;padding:16px;display:flex;flex-direction:column;gap:10px}
 .msg{max-width:72ch;padding:10px 12px;border-radius:10px;white-space:pre-wrap}
 .user{background:#2b4a7a;align-self:flex-end}
 .bot{background:#1d2430;align-self:flex-start}
 form{display:flex;gap:8px;padding:12px;background:#161b24}
 input{flex:1;padding:10px;border-radius:8px;border:1px solid #333;
       background:#0d1117;color:#e6e6e6}
 button{padding:10px 18px;border-radius:8px;border:0;background:#2b4a7a;
        color:#fff;cursor:pointer}
 small{color:#8b949e;padding:0 16px 8px}
</style></head><body>
<header>llm-tpu server</header>
<div id="log"></div>
<small id="stats"></small>
<form id="f"><input id="q" placeholder="Say something..." autocomplete="off">
<button>Send</button></form>
<script>
const log=document.getElementById('log'),f=document.getElementById('f'),
      q=document.getElementById('q'),stats=document.getElementById('stats');
const history=[];
function add(cls,text){const d=document.createElement('div');
 d.className='msg '+cls;d.textContent=text;log.appendChild(d);
 log.scrollTop=log.scrollHeight;return d}
f.onsubmit=async(e)=>{e.preventDefault();const text=q.value.trim();
 if(!text)return;q.value='';add('user',text);
 history.push({role:'user',content:text});
 const d=add('bot','');const t0=performance.now();let n=0;
 const r=await fetch('/v1/chat/completions',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify({messages:history,stream:true,max_tokens:512})});
 const rd=r.body.getReader();const dec=new TextDecoder();let buf='';
 for(;;){const{value,done}=await rd.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  for(;;){const i=buf.indexOf('\\n');if(i<0)break;
   const line=buf.slice(0,i).trim();buf=buf.slice(i+1);
   if(!line.startsWith('data: '))continue;const p=line.slice(6);
   if(p==='[DONE]')continue;
   try{const j=JSON.parse(p);const c=j.choices[0].delta?.content;
    if(c){d.textContent+=c;n++;log.scrollTop=log.scrollHeight}}catch{}}}
 history.push({role:'assistant',content:d.textContent});
 const dt=(performance.now()-t0)/1000;
 stats.textContent=`${n} tokens in ${dt.toFixed(1)}s (${(n/dt).toFixed(1)} tok/s)`};
</script></body></html>
"""
